// The fused IR residual block for Hopper: one launch computes
//   out = dtype(bn2(conv3x3(u)) + x),  u = dtype(prelu(conv3x3(dtype(bn1(x)))))
// for x (N, H, W, C) NHWC in bf16 or f32, both 3x3 convs stride 1 pad 1,
// identity shortcut, no SE: the 20 stride-1 identity blocks of IR-50
// (facekit_torch/models/arcface.py `IRBlock.forward` -> ops/ir_block.py).
//
// Replaces: the TPU kernel `ir_block_fused` -> `_ir_block_kernel` in
// docs/experiments/fused_block_kernel.py:49-115, with its numerics: the BN
// affines come in as f32 (scale, shift) pairs, t = dtype(f32(x)*s1 + b1),
// both convs accumulate in f32, u = dtype(m1 > 0 ? m1 : m1*alpha) and is 0
// on rows outside the image (conv2 pads u, not prelu of a padded conv1),
// out = dtype(m2*s2 + b2 + f32(x)) rounded once. Every product and sum of
// the epilogues is an explicit _rn intrinsic, so none is contracted into an
// FMA that the plain version does not have. The TPU kernel's layout tricks
// (H-only padding, the im2col of 9 shifted copies in VMEM) were for Mosaic
// and are not carried over.
//
// Bound on an H100 SXM: x read once, out written once, both weights read
// once: 2*N*H*W*C*b + 2*9*C*C*b bytes; 2 convs of 2*N*H*W*9*C*C operations
// each. Every IR-50 shape has W*C = 3,584, so a block is 2 x 231.2 MFLOP per
// image against 2 x 7.2 KB per image row: at the bf16 tensor-core rate it is
// bound by operations (14x14x256 at batch 32: 14.8 GFLOP, 0.015 ms, against
// 3.2 MB, 0.001 ms). chip_smoke.py computes the bound of every case it runs.
//
// Design, right and simple first (tensor cores and TMA are later work):
//  * A cluster of G = C/64 CTAs per (image, band of R = 4 output rows); CTA
//    g of the cluster owns output channels 64g .. 64g+63 of both convs, so
//    every IR-50 shape at batch 8 launches 112-128 CTAs. Each CTA builds t
//    for the R+4 image rows the band needs, all C channels, in shared
//    memory (zero rows outside the image, zero columns either side), and
//    computes its 64 channels of u on the R+2 rows conv2 needs into its own
//    shared memory (rounded to the dtype, zero rows outside the image).
//    After a cluster barrier, conv2 reads all C channels of u from the
//    cluster's CTAs through distributed shared memory, and the f32
//    epilogue writes its 64 channels of the R output rows; a second
//    barrier keeps every CTA's u alive until the cluster is done with it.
//    conv1 on the halo rows is computed by both neighbouring bands:
//    (R+2)/R of conv1's work. Shared memory per CTA: 86-112 KB in bf16,
//    up to 211 KB in f32 (56x56x64).
//  * Each conv is an implicit GEMM from shared memory: 64-pixel tiles x the
//    CTA's 64 output channels, K = 9*C in the weight's (kh, kw, c) order, so
//    a K stage of 32 is 32 channels of one tap. The weights (O, 3, 3, C)
//    stream from L2 into a 32 x 64 f32 stage in shared memory; each of 256
//    threads accumulates a 4-pixel x 4-channel f32 micro-tile (CUDA-core
//    FMAs), two channels of A per shared load.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TM = 64;   // pixels per tile
constexpr int TN = 64;   // output channels per tile
constexpr int KC = 32;   // K per weight stage

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// two consecutive elements (8- or 4-byte aligned) as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// four consecutive elements of global memory as floats
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&a);
  q.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// One 3x3 conv over `rows` output rows of a band held in shared memory
// (rows of W+2 pixels, zero columns at 0 and W+1), for this CTA's TN output
// channels o_base .. o_base+TN-1, as an implicit GEMM. `a_src(c0)` gives the
// band's element (pixel 0, channel c0) and the pixel stride for the K stage
// of channels c0 .. c0+KC-1. Calls epi(row, col, j0, acc[4]) for each valid
// output pixel with this thread's 4 consecutive channels j0..j0+3 (j0 < TN).
template <typename T, typename ASrc, typename Epi>
__device__ __forceinline__ void conv_band(ASrc a_src, const T* __restrict__ w,
                                          float* Bs, int rows, int W, int C,
                                          int o_base, Epi epi) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;          // channels tx*4 .. tx*4+3 of the tile
  const int ty = tid >> 4;          // pixels ty*4 .. ty*4+3 of a tile
  const int K = 9 * C;
  const int P = rows * W;
  const int W2 = W + 2;
  // weight-stage loading role: output channel ld_o, K entries ld_k..+7
  const int ld_o = tid >> 2;
  const int ld_k = (tid & 3) * 8;
  const T* wrow = w + (size_t)(o_base + ld_o) * K + ld_k;

  for (int p0 = 0; p0 < P; p0 += TM) {
    int base[4];                    // band offset (pixels) of each pixel
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
      ok[i] = p < P;
      const int pp = ok[i] ? p : 0;
      base[i] = (pp / W) * W2 + (pp % W);
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += KC) {
      float wa[4], wb[4];
      load4(wrow + k0, wa);
      load4(wrow + k0 + 4, wb);
      __syncthreads();              // the previous stage is consumed
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        Bs[(ld_k + q) * TN + ld_o] = wa[q];
        Bs[(ld_k + 4 + q) * TN + ld_o] = wb[q];
      }
      __syncthreads();

      const int tap = k0 / C;
      int ps;
      const T* src = a_src(k0 - tap * C, ps);
      const int toff = (tap / 3) * W2 + (tap % 3);
      const T* a0 = src + (size_t)(base[0] + toff) * ps;
      const T* a1 = src + (size_t)(base[1] + toff) * ps;
      const T* a2 = src + (size_t)(base[2] + toff) * ps;
      const T* a3 = src + (size_t)(base[3] + toff) * ps;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 2) {
        const float2 av[4] = {load2(a0 + kk), load2(a1 + kk), load2(a2 + kk),
                              load2(a3 + kk)};
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk * TN + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[(kk + 1) * TN + tx * 4]);
        const float bv0[4] = {b0.x, b0.y, b0.z, b0.w};
        const float bv1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(av[i].x, bv0[j], acc[i][j]);
            acc[i][j] = fmaf(av[i].y, bv1[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ok[i]) {
        const int p = p0 + ty * 4 + i;
        epi(p / W, p % W, tx * 4, acc[i]);
      }
    }
  }
}

// Grid (bands * G, N), clusters of G = C / TN CTAs along x: the G CTAs of a
// cluster share one band of one image, and CTA g of the cluster owns output
// channels g*TN .. g*TN+TN-1 of both convs.
template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
ir_block_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                const T* __restrict__ w2, const float* __restrict__ par,
                T* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  const int W2 = W + 2;
  T* tband = reinterpret_cast<T*>(smem);                     // (R+4, W+2, C)
  T* uband = tband + (size_t)(R + 4) * W2 * C;               // (R+2, W+2, TN)
  float* Bs = reinterpret_cast<float*>(uband + (size_t)(R + 2) * W2 * TN);

  const int n = blockIdx.y;
  const int r0 = (blockIdx.x / G) * R;
  const int o_base = g * TN;
  const T* xn = x + (size_t)n * H * W * C;
  const float* s1 = par;
  const float* b1 = par + C;
  const float* alpha = par + 2 * C + o_base;
  const float* s2 = par + 3 * C + o_base;
  const float* b2 = par + 4 * C + o_base;
  const T zero = from_f<T>(0.f);

  // t = dtype(f32(x)*s1 + b1) on image rows r0-2 .. r0+R+1 (all C
  // channels: every output channel of conv1 reads them all), 0 elsewhere
  const int WC = W * C;
  for (int e = threadIdx.x; e < (R + 4) * WC; e += THREADS) {
    const int i = e / WC;
    const int rem = e - i * WC;
    const int col = rem / C;
    const int c = rem - col * C;
    const int gy = r0 - 2 + i;
    T v = zero;
    if (gy >= 0 && gy < H)
      v = from_f<T>(__fadd_rn(__fmul_rn(to_f(xn[(size_t)gy * WC + rem]), s1[c]), b1[c]));
    tband[((size_t)i * W2 + col + 1) * C + c] = v;
  }
  // zero columns 0 and W+1 of both bands
  for (int e = threadIdx.x; e < (R + 4) * 2 * C; e += THREADS) {
    const int i = e / (2 * C);
    const int c = e - i * 2 * C;
    const int col = c < C ? 0 : W + 1;
    tband[((size_t)i * W2 + col) * C + (c < C ? c : c - C)] = zero;
  }
  for (int e = threadIdx.x; e < (R + 2) * 2 * TN; e += THREADS) {
    const int i = e / (2 * TN);
    const int c = e - i * 2 * TN;
    const int col = c < TN ? 0 : W + 1;
    uband[((size_t)i * W2 + col) * TN + (c < TN ? c : c - TN)] = zero;
  }
  __syncthreads();

  // u on image rows r0-1 .. r0+R, this CTA's channels: prelu of conv1,
  // rounded, 0 off the image
  conv_band<T>(
      [&](int c0, int& ps) { ps = C; return (const T*)tband + c0; },
      w1, Bs, R + 2, W, C, o_base,
      [&](int i, int col, int j0, const float (&acc)[4]) {
        const int gy = r0 - 1 + i;
        const bool in = gy >= 0 && gy < H;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float m = acc[j];
          v[j] = in ? (m > 0.f ? m : __fmul_rn(m, alpha[j0 + j])) : 0.f;
        }
        store4(uband + ((size_t)i * W2 + col + 1) * TN + j0, v);
      });
  cluster.sync();                   // every CTA's u slice is written

  // out on image rows r0 .. r0+R-1, this CTA's channels: bn2 of conv2
  // over all C channels of u (read from the cluster's CTAs), plus x
  T* on = out + (size_t)n * H * W * C;
  conv_band<T>(
      [&](int c0, int& ps) {
        ps = TN;
        return (const T*)cluster.map_shared_rank(uband, c0 / TN) + c0 % TN;
      },
      w2, Bs, R, W, C, o_base,
      [&](int i, int col, int j0, const float (&acc)[4]) {
        const int gy = r0 + i;
        if (gy >= H) return;
        const size_t off = ((size_t)gy * W + col) * C + o_base + j0;
        float res[4], v[4];
        load4(xn + off, res);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = __fadd_rn(__fadd_rn(__fmul_rn(acc[j], s2[j0 + j]), b2[j0 + j]),
                           res[j]);
        store4(on + off, v);
      });
  cluster.sync();                   // no CTA leaves while its u is read
}

template <typename T, int R>
int launch(cudaStream_t s, const void* x, const void* w1, const void* w2,
           const float* par, void* out, int N, int H, int W, int C) {
  const int G = C / TN;
  const size_t smem = (size_t)(R + 4) * (W + 2) * C * sizeof(T) +
                      (size_t)(R + 2) * (W + 2) * TN * sizeof(T) +
                      (size_t)KC * TN * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ir_block_kernel<T, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((H + R - 1) / R) * G, N);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ir_block_kernel<T, R>, static_cast<const T*>(x),
                           static_cast<const T*>(w1), static_cast<const T*>(w2), par,
                           static_cast<T*>(out), H, W, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). Launches on `stream` and returns the
// CUDA error as an int; it never synchronizes. The caller has checked: x and
// out (N, H, W, C), w1 and w2 (C, 3, 3, C) in one dtype (0 = f32, 1 = bf16),
// par (5, C) f32 = s1, b1, alpha, s2, b2, all contiguous on one device; C a
// multiple of 64 up to 512; N*H*W*C below 2**31.
extern "C" int facekit_ir_block(const void* x, const void* w1, const void* w2,
                                const void* par, void* out, int N, int H, int W,
                                int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(par);
  if (dtype == 1)
    return launch<__nv_bfloat16, 4>(s, x, w1, w2, p, out, N, H, W, C);
  return launch<float, 4>(s, x, w1, w2, p, out, N, H, W, C);
}
