// s8 x s8 -> s32 convolution for Hopper: x (N, H, W, C) int8 NHWC, w (O, KS,
// KS, C) int8, symmetric zero padding, out (N, OH, OW, O) int32. Every conv
// site of the int8 ArcFace runs through it (facekit_torch/models/layers.py
// `conv2d_int8`, which quantizes before and dequantizes after).
//
// Replaces: the TPU kernel `conv_s8_s2_pallas` -> `_kernel` in
// docs/experiments/pallas_s8_stride2_conv.py:46-104, an s8 3x3 stride-2
// pad-1 convolution at C = 64, 112x112 written as one im2col matmul per
// image, made general here: KS in {1, 3}, stride in {1, 2}, pad in {0, 1},
// C a power of two >= 4 (the wrapper pads the stem's 3 channels to 4 with
// zeros, which is exact), O a multiple of 64. The result is the exact
// integer sum, as the TPU kernel's s32 accumulation gives it.
//
// Bound on an H100 SXM: x read once, w read once, out written once,
// N*H*W*C + O*KS*KS*C + 4*N*OH*OW*O bytes at 3.35 TB/s, against
// 2*N*OH*OW*O*KS*KS*C operations at the int8 tensor-core rate (1,979 TOPS).
// Kernel #4's own shape at N = 256 moves 0.411 GB (0.123 ms) for 59.2 G
// operations (0.030 ms): bound by bytes, since the int32 output is as
// large as the s8 input. chip_smoke.py computes the bound of every IR-50
// shape it runs.
//
// Design, right first (tensor cores, TMA and fused quantize/dequant
// epilogues are later work):
//  * An implicit GEMM: M = N*OH*OW output pixels, N_gemm = O, K = KS*KS*C
//    taken in the weight's order (kh, kw, c), so a run of K is a run of
//    input channels of one tap, contiguous in NHWC. No im2col buffer: each
//    CTA gathers its patch rows straight from x, and out-of-image taps and
//    K past its end read 0.
//  * A CTA computes 64 pixels x 64 output channels with 256 threads; each
//    thread accumulates a 4 x 4 micro-tile in int32 with __dp4a (4 s8
//    products per instruction), reading 4 pixel words and 4 weight words
//    of the stage from shared memory per 16 __dp4a.
//  * K goes in stages of 64 bytes: each thread loads 16 bytes of one pixel
//    and 16 of one weight row (one 16-byte load when C is a multiple of 16,
//    else four 4-byte loads, each of its own tap), stores them transposed
//    to shared memory (word-major, rows padded to keep 16-byte alignment),
//    and loads the next stage into registers while it computes on this
//    one, with two shared buffers and one barrier per stage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output pixels per CTA
constexpr int BN = 64;          // output channels per CTA
constexpr int BKW = 16;         // 4-byte words of K per stage (64 bytes)
constexpr int THREADS = 256;
constexpr int PAD = 4;          // shared row padding in words (keeps 16 B alignment)

// This thread's 16 bytes of K (kb0 .. kb0+15) of its output pixel's patch
// row. The pixel's top-left input corner is (ih0, iw0) in image xb.
template <int KS, bool WIDE>
__device__ __forceinline__ void load_a(int (&ra)[4], const int8_t* __restrict__ xb,
                                       bool m_ok, int ih0, int iw0, int H, int W,
                                       int lc, int K, int kb0) {
  const int cmask = (1 << lc) - 1;
  if constexpr (WIDE) {
    int4 v = make_int4(0, 0, 0, 0);
    if (m_ok && kb0 < K) {
      const int tap = kb0 >> lc;
      const int kh = tap / KS, kw = tap - (tap / KS) * KS;
      const int ih = ih0 + kh, iw = iw0 + kw;
      if ((unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W)
        v = __ldg(reinterpret_cast<const int4*>(
            xb + (((size_t)ih * W + iw) << lc) + (kb0 & cmask)));
    }
    ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kb = kb0 + 4 * i;
      int v = 0;
      if (m_ok && kb < K) {
        const int tap = kb >> lc;
        const int kh = tap / KS, kw = tap - (tap / KS) * KS;
        const int ih = ih0 + kh, iw = iw0 + kw;
        if ((unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W)
          v = __ldg(reinterpret_cast<const int*>(
              xb + (((size_t)ih * W + iw) << lc) + (kb & cmask)));
      }
      ra[i] = v;
    }
  }
}

// This thread's 16 bytes of K (kb0 .. kb0+15) of its weight row wb.
template <bool WIDE>
__device__ __forceinline__ void load_b(int (&rb)[4], const int8_t* __restrict__ wb,
                                       int K, int kb0) {
  if constexpr (WIDE) {
    int4 v = make_int4(0, 0, 0, 0);
    if (kb0 < K) v = __ldg(reinterpret_cast<const int4*>(wb + kb0));
    rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kb = kb0 + 4 * i;
      rb[i] = kb < K ? __ldg(reinterpret_cast<const int*>(wb + kb)) : 0;
    }
  }
}

template <int KS, bool WIDE>
__global__ void __launch_bounds__(THREADS)
conv_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               int32_t* __restrict__ out, int H, int W, int lc, int O,
               int OH, int OW, int stride, int pad, int M) {
  __shared__ __align__(16) int As[2][BKW][BM + PAD];   // [word][pixel]
  __shared__ __align__(16) int Bs[2][BKW][BN + PAD];   // [word][channel]

  const int K = KS * KS << lc;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // loading role: pixel / weight row ld_p, words ld_w .. ld_w+3 of a stage
  const int ld_p = tid >> 2;
  const int ld_w = (tid & 3) * 4;
  const int m = m0 + ld_p;
  const bool m_ok = m < M;
  int ih0 = 0, iw0 = 0;
  const int8_t* xb = x;
  if (m_ok) {
    const int img = m / (OH * OW);
    const int r = m - img * (OH * OW);
    const int oh = r / OW;
    const int ow = r - oh * OW;
    ih0 = oh * stride - pad;
    iw0 = ow * stride - pad;
    xb = x + (((size_t)img * H * W) << lc);
  }
  const int8_t* wb = w + (size_t)(n0 + ld_p) * K;

  // computing role: pixels ty*4 .. ty*4+3, channels tx*4 .. tx*4+3
  const int tx = tid & 15;
  const int ty = tid >> 4;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  }

  const int nk = (K + 4 * BKW - 1) / (4 * BKW);
  int ra[4], rb[4];
  load_a<KS, WIDE>(ra, xb, m_ok, ih0, iw0, H, W, lc, K, ld_w * 4);
  load_b<WIDE>(rb, wb, K, ld_w * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    As[0][ld_w + i][ld_p] = ra[i];
    Bs[0][ld_w + i][ld_p] = rb[i];
  }
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      const int kb0 = (kt + 1) * 4 * BKW + ld_w * 4;
      load_a<KS, WIDE>(ra, xb, m_ok, ih0, iw0, H, W, lc, K, kb0);
      load_b<WIDE>(rb, wb, K, kb0);
    }
#pragma unroll
    for (int kw = 0; kw < BKW; ++kw) {
      const int4 a = *reinterpret_cast<const int4*>(&As[cur][kw][ty * 4]);
      const int4 b = *reinterpret_cast<const int4*>(&Bs[cur][kw][tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        As[cur ^ 1][ld_w + i][ld_p] = ra[i];
        Bs[cur ^ 1][ld_w + i][ld_p] = rb[i];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mo = m0 + ty * 4 + i;
    if (mo < M)
      *reinterpret_cast<int4*>(out + (size_t)mo * O + n0 + tx * 4) =
          make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <int KS, bool WIDE>
void launch(cudaStream_t s, const void* x, const void* w, void* out, int H,
            int W, int lc, int O, int OH, int OW, int stride, int pad, int M) {
  const dim3 grid((M + BM - 1) / BM, O / BN);
  conv_s8_kernel<KS, WIDE><<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), H, W, lc, O, OH, OW, stride, pad, M);
}

}  // namespace

// C entry point (loaded with ctypes). Launches on `stream` and returns
// cudaGetLastError() as an int; it never synchronizes. The caller has
// checked: x (N, H, W, 2**log2_c) and w (O, ks, ks, 2**log2_c) int8 and out
// (N, OH, OW, O) int32, all contiguous and 16-byte aligned; log2_c >= 2;
// ks in {1, 3}; O a multiple of 64; N*OH*OW*O and N*H*W*C below 2**31.
extern "C" int facekit_conv_s8(const void* x, const void* w, void* out,
                               int N, int H, int W, int log2_c, int O, int ks,
                               int stride, int pad, int OH, int OW,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * OH * OW;
  const bool wide = log2_c >= 4;         // C a multiple of 16
  if (ks == 1) {
    if (wide) launch<1, true>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M);
    else launch<1, false>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M);
  } else {
    if (wide) launch<3, true>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M);
    else launch<3, false>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M);
  }
  return static_cast<int>(cudaGetLastError());
}
