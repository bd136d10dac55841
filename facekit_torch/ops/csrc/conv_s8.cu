// s8 x s8 -> s32 convolution for Hopper: x (N, H, W, C) int8 NHWC, w (O, KS,
// KS, C / groups) int8, symmetric zero padding, out (N, OH, OW, O) int32.
// Every conv site of the int8 ArcFace and of the int8 detectors runs
// through it (facekit_torch/models/layers.py `conv2d_int8`, which quantizes
// before and dequantizes after).
//
// Replaces: the TPU kernel `conv_s8_s2_pallas` -> `_kernel` in
// docs/experiments/pallas_s8_stride2_conv.py:46-104, an s8 3x3 stride-2
// pad-1 convolution at C = 64, 112x112 written as one im2col matmul per
// image, made general here: KS in {1, 3}, stride in {1, 2}, pad in {0, 1},
// C a power of two >= 4 (the wrapper pads the stem's 3 channels to 4 with
// zeros, which is exact), O a multiple of 8; or depthwise (groups = C = O,
// 3x3, C a multiple of 4). The result is the exact integer sum, as the TPU
// kernel's s32 accumulation gives it.
//
// Bound on an H100 SXM: x read once, w read once, out written once,
// N*H*W*C + O*KS*KS*C + 4*N*OH*OW*O bytes at 3.35 TB/s, against
// 2*N*OH*OW*O*KS*KS*C operations at the int8 tensor-core rate (1,979 TOPS).
// Kernel #4's own shape at N = 256 moves 0.411 GB (0.123 ms) for 59.2 G
// operations (0.030 ms): bound by bytes, since the int32 output is as
// large as the s8 input. IR-50's 3x3 sites at 14x14 and 7x7 are bound by
// operations. chip_smoke.py computes the bound of every shape it runs.
//
// Three routes, chosen in the wrapper (`conv_route`): groups > 1 runs the
// depthwise kernel; else the plan names the route (bn = 0: the __dp4a
// kernel).
//
// C >= 16: an implicit GEMM on s8 tensor cores (conv_s8_mma_kernel).
//  * M = N*OH*OW output pixels, N_gemm = O, K = KS*KS*C in the weight's
//    order (kh, kw, c), so a 16-byte run of K is 16 input channels of one
//    tap, contiguous in NHWC. No im2col buffer: each CTA gathers its patch
//    rows straight from x.
//  * A CTA computes 128 pixels x BN channels (BN = 128 where O allows it,
//    else 64) with 8 warps; K goes in stages of 128 bytes. An O that is no
//    multiple of 64 (the detectors' 8, 16 and 32; any multiple of 8) ends
//    in a tile partly past O: its weight rows past O zero-fill like the K
//    tail, and the epilogue skips their 16-byte runs. Each thread
//    copies 16-byte runs of A (patch rows) and B (weight rows, K-contiguous:
//    the .col operand) with cp.async.cg into a ring of MST stages; rows are
//    padded by 16 bytes so that ldmatrix's eight row addresses fall in
//    distinct banks. Out-of-image taps, pixels past M and K past its end
//    copy 0 bytes of the source and zero-fill (cp.async's src-size).
//  * Each warp holds a (128 / WARPS_M) x 32 tile of s32 accumulators and,
//    per 32-byte K step, loads A and B with ldmatrix.x4 into mma.sync
//    m16n8k32 (mma_s8 in mma_bf16.cuh: the operand layout of the search's
//    tensor-core pass 1, topk_mma.cuh).
//  * The grid is (tiles, splits), the O / BN tiles of one run of pixels
//    next to each other in blockIdx.x, so that they read its patch rows
//    from L2 together.
//  * Split-K: where the tiles give fewer CTAs than the card has SMs (small
//    batches, late stages), blockIdx.y takes a run of whole stages and the
//    splits of one tile run as one thread-block cluster (at most 8 CTAs,
//    the portable size). Each CTA leaves its partial tile in its shared
//    memory; after a cluster barrier each sums a share of the tile's rows
//    over every CTA's tile through distributed shared memory and writes
//    them out. No atomics, no zeroed output, no second launch; int32 sums
//    are exact, so the result is bit-equal to a single pass.
//  * Epilogue: the accumulator tile goes through shared memory (the ring,
//    reused), so that each thread writes 16 bytes of one pixel's channels
//    and a warp whole runs of a pixel row.
//
// C < 16 (the stems, 8-channel inputs): conv_s8_dp4a_kernel on CUDA cores.
// Each thread accumulates a 4 x 4 micro-tile of a 64 x 64 CTA tile with
// __dp4a, from 4-byte words of K (one tap each) loaded into registers a
// stage ahead and stored transposed to shared memory. K is 36 bytes at a
// stem, too thin for an m16n8k32 and bound by the bytes of its output.
// Weight rows past O read as 0 and their stores are skipped.
//
// groups = C (the detectors' depthwise 3x3 sites): conv_s8_dw_kernel on
// CUDA cores. No sum runs across channels, so there is no matrix product
// for the tensor cores: each thread sums the 9 taps of VEC channels (16,
// or 4 where C is no multiple of 16) of one output pixel in int32, from
// one VEC-byte load of x per tap (neighbouring threads on neighbouring
// channels) and its 9*VEC weight bytes, contiguous in the (C, 3, 3, 1)
// weight. Bound by bytes: N*H*W*C in, 9*C weights, 4*N*OH*OW*C out.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// the tensor-core route (C >= 16)

constexpr int BM = 128;             // output pixels per CTA
constexpr int BK = 128;             // bytes of K per stage
constexpr int ROWB = BK + 16;       // shared row stride in bytes
constexpr int MAX_SPLITS = 8;       // CTAs of a cluster (the portable most)

template <int BN>
struct MmaConv {
  static constexpr int MST = BN == 128 ? 3 : 4;      // stages in the ring
  static constexpr int A_BYTES = BM * ROWB;
  static constexpr int STAGE = (BM + BN) * ROWB;
  static constexpr int WARPS_N = BN / 32;            // 4 or 2
  static constexpr int WARPS_M = 8 / WARPS_N;        // 2 or 4
  static constexpr int MT = BM / WARPS_M / 16;       // m16 tiles a warp: 4 or 2
  static constexpr int CSTR = BN + 8;                // epilogue row, in words
  static constexpr int SMEM = MST * STAGE > BM * CSTR * 4 ? MST * STAGE
                                                          : BM * CSTR * 4;
};

template <int KS, int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv_s8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int32_t* __restrict__ out, int H, int W, int lc, int O,
                   int OH, int OW, int stride, int pad, int M, int per_split) {
  using P = MmaConv<BN>;
  constexpr int MST = P::MST, MT = P::MT, CSTR = P::CSTR;
  extern __shared__ __align__(16) unsigned char smem[];

  const int K = KS * KS << lc;
  const int n_tiles = (O + BN - 1) / BN;   // the n tiles of an m tile run
                                           // together
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int kst = (K + BK - 1) / BK;
  const int s0 = blockIdx.y * per_split;
  const int nst = min(kst, s0 + per_split) - s0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // loading role: the 16-byte column ld_col of rows ld_row + 32u of A
  // (pixels) and B (output channels)
  const int ld_row = tid >> 3, ld_col = (tid & 7) * 16;
  constexpr int AU = BM / 32, BU = BN / 32;
  int a_pix[AU], a_ih[AU], a_iw[AU];   // image's first pixel, top-left tap
#pragma unroll
  for (int u = 0; u < AU; ++u) {
    const int m = m0 + ld_row + 32 * u;
    a_pix[u] = 0;
    a_ih[u] = -(1 << 30);                 // past M: every tap out of image
    a_iw[u] = 0;
    if (m < M) {
      const int img = m / (OH * OW);
      const int r = m - img * (OH * OW);
      const int oh = r / OW;
      a_pix[u] = img * H * W;
      a_ih[u] = oh * stride - pad;
      a_iw[u] = (r - oh * OW) * stride - pad;
    }
  }
  const uint32_t smem_s = smem_u32(smem);
  auto load_stage = [&](int s, int buf) {
    const int kb = s * BK + ld_col;
    const bool k_ok = kb < K;
    const int tap = kb >> lc;
    const int kh = tap / KS, kw = tap - (tap / KS) * KS;
    const int c = kb & ((1 << lc) - 1);
    const uint32_t dst = smem_s + buf * P::STAGE + ld_row * ROWB + ld_col;
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      const int ih = a_ih[u] + kh, iw = a_iw[u] + kw;
      const bool ok = k_ok && (unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W;
      const int8_t* src = ok ? x + ((size_t)(a_pix[u] + ih * W + iw) << lc) + c : x;
      cp_async16_zfill(dst + u * 32 * ROWB, src, ok);
    }
#pragma unroll
    for (int u = 0; u < BU; ++u) {
      const int n = n0 + ld_row + 32 * u;   // rows past O: zero-fill
      const bool ok = k_ok && n < O;
      const int8_t* src = ok ? w + (size_t)n * K + kb : w;
      cp_async16_zfill(dst + P::A_BYTES + u * 32 * ROWB, src, ok);
    }
  };

  // warp tile: pixels wm*16*MT .. +16*MT-1, channels wn*32 .. +31
  const int wm = warp / P::WARPS_N, wn = warp % P::WARPS_N;
  uint32_t a_lane[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    a_lane[i] = smem_s + (wm * 16 * MT + i * 16 + (lane & 15)) * ROWB + (lane >> 4) * 16;
  // B: lanes 0-7 / 8-15 / 16-23 / 24-31 address n-tile 0 bytes 0-15 /
  // n-tile 0 bytes 16-31 / n-tile 1 bytes 0-15 / n-tile 1 bytes 16-31 of a
  // 32-byte K step of a pair of n8 tiles
  const uint32_t b_lane = smem_s + P::A_BYTES +
      (wn * 32 + (lane & 7) + (lane >> 4) * 8) * ROWB + ((lane >> 3) & 1) * 16;

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < MST - 1; ++s) {
    if (s < nst) load_stage(s0 + s, s);
    cp_async_commit();
  }
  int buf = 0, ld_buf = MST - 1;
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<MST - 2>();          // stage s has landed
    __syncthreads();                   // ... for every thread, and stage
                                       // s-1 is consumed
    if (s + MST - 1 < nst) load_stage(s0 + s + MST - 1, ld_buf);
    cp_async_commit();
    if (++ld_buf == MST) ld_buf = 0;

    const uint32_t st = buf * P::STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t b[4][2], r[4];
      ldmatrix_x4(r, b_lane + st + kk * 32);
      b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
      ldmatrix_x4(r, b_lane + st + 16 * ROWB + kk * 32);
      b[2][0] = r[0]; b[2][1] = r[1]; b[3][0] = r[2]; b[3][1] = r[3];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, a_lane[i] + st + kk * 32);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
    if (++buf == MST) buf = 0;
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the epilogue

  // lane l holds pixels l/4 and l/4 + 8, channels 2(l%4) and 2(l%4)+1 of
  // each (m16, n8) tile: to a BM x BN int32 tile in shared memory
  int* cs = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = wm * 16 * MT + i * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wn * 32 + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<int2*>(cs + row * CSTR + col) = make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(cs + (row + 8) * CSTR + col) = make_int2(acc[i][j][2], acc[i][j][3]);
    }
  }
  __syncthreads();
  // each thread writes 16 bytes of one pixel; BN/4 threads cover a pixel
  constexpr int TPR = BN / 4, RPP = THREADS / TPR;
  const int er = tid / TPR, ec = (tid % TPR) * 4;
  const bool col_ok = n0 + ec < O;     // O % 4 == 0: a run is in or out
  if (gridDim.y == 1) {
    if (!col_ok) return;
    for (int r = er; r < BM && m0 + r < M; r += RPP)
      *reinterpret_cast<int4*>(out + (size_t)(m0 + r) * O + n0 + ec) =
          *reinterpret_cast<const int4*>(cs + r * CSTR + ec);
    return;
  }
  // split K: the gridDim.y CTAs of this tile are one cluster; CTA `rank`
  // sums the row groups rank, rank + splits, ... over every CTA's tile
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();                      // every partial tile is in place
  for (int g = rank; g * RPP < BM; g += splits) {
    const int r = g * RPP + er;
    if (m0 + r >= M || !col_ok) break;
    int4 v = make_int4(0, 0, 0, 0);
    for (int q = 0; q < splits; ++q) {
      const int4 p = *reinterpret_cast<const int4*>(
          cluster.map_shared_rank(cs + r * CSTR + ec, q));
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    *reinterpret_cast<int4*>(out + (size_t)(m0 + r) * O + n0 + ec) = v;
  }
  cluster.sync();                      // no CTA leaves while its tile is read
}

// Returns the CUDA error of setting the shared-memory size or of the
// launch, as an int.
template <int KS, int BN>
int launch_mma(cudaStream_t s, const void* x, const void* w, void* out, int H,
               int W, int lc, int O, int OH, int OW, int stride, int pad, int M,
               int splits, int per_split) {
  constexpr int smem = MmaConv<BN>::SMEM;
  auto kernel = conv_s8_mma_kernel<KS, BN>;
  // the shared-memory size, set once per instantiation and device rather
  // than on every launch
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = true;
  }
  // the splits of a tile are one cluster of (1, splits, 1) CTAs
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((O + BN - 1) / BN * ((M + BM - 1) / BM), splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), H, W, lc, O, OH, OW, stride, pad, M,
      per_split));
}

// ---------------------------------------------------------------------------
// the CUDA-core route (C < 16: the stem)

constexpr int DBM = 64;          // output pixels per CTA
constexpr int DBN = 64;          // output channels per CTA
constexpr int BKW = 16;          // 4-byte words of K per stage (64 bytes)
constexpr int PAD = 4;           // shared row padding in words (keeps 16 B alignment)

// This thread's 16 bytes of K (kb0 .. kb0+15) of its output pixel's patch
// row, one 4-byte word (one tap) at a time. The pixel's top-left input
// corner is (ih0, iw0) in image xb.
template <int KS>
__device__ __forceinline__ void load_a(int (&ra)[4], const int8_t* __restrict__ xb,
                                       bool m_ok, int ih0, int iw0, int H, int W,
                                       int lc, int K, int kb0) {
  const int cmask = (1 << lc) - 1;
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

// This thread's 16 bytes of K (kb0 .. kb0+15) of its weight row wb; 0 for
// a row past O (n_ok false).
__device__ __forceinline__ void load_b(int (&rb)[4], const int8_t* __restrict__ wb,
                                       bool n_ok, int K, int kb0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kb = kb0 + 4 * i;
    rb[i] = n_ok && kb < K ? __ldg(reinterpret_cast<const int*>(wb + kb)) : 0;
  }
}

template <int KS>
__global__ void __launch_bounds__(THREADS)
conv_s8_dp4a_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    int32_t* __restrict__ out, int H, int W, int lc, int O,
                    int OH, int OW, int stride, int pad, int M) {
  __shared__ __align__(16) int As[2][BKW][DBM + PAD];   // [word][pixel]
  __shared__ __align__(16) int Bs[2][BKW][DBN + PAD];   // [word][channel]

  const int K = KS * KS << lc;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * DBM;
  const int n0 = blockIdx.y * DBN;

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
  const bool n_ok = n0 + ld_p < O;
  const int8_t* wb = w + (size_t)(n_ok ? n0 + ld_p : 0) * K;

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
  load_a<KS>(ra, xb, m_ok, ih0, iw0, H, W, lc, K, ld_w * 4);
  load_b(rb, wb, n_ok, K, ld_w * 4);
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
      load_a<KS>(ra, xb, m_ok, ih0, iw0, H, W, lc, K, kb0);
      load_b(rb, wb, n_ok, K, kb0);
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

  if (n0 + tx * 4 >= O) return;       // O % 4 == 0: a run is in or out
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mo = m0 + ty * 4 + i;
    if (mo < M)
      *reinterpret_cast<int4*>(out + (size_t)mo * O + n0 + tx * 4) =
          make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <int KS>
int launch_dp4a(cudaStream_t s, const void* x, const void* w, void* out, int H,
                int W, int lc, int O, int OH, int OW, int stride, int pad, int M) {
  const dim3 grid((M + DBM - 1) / DBM, (O + DBN - 1) / DBN);
  conv_s8_dp4a_kernel<KS><<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), H, W, lc, O, OH, OW, stride, pad, M);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the depthwise route (groups = C = O, 3x3)

// signed byte b (a constant after unrolling) of the word v
__device__ __forceinline__ int sbyte(uint32_t v, int b) {
  return static_cast<int>(static_cast<int8_t>(v >> (8 * b)));
}

// VEC channels of one output pixel a thread: 16, or 4 where C % 16 != 0
template <int VEC>
__global__ void __launch_bounds__(THREADS)
conv_s8_dw_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  int32_t* __restrict__ out, int H, int W, int C, int OH,
                  int OW, int stride, int pad, int total) {
  static_assert(VEC == 4 || VEC == 16, "VEC is 4 or 16");
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int runs = C / VEC;
  const int pix = t / runs;            // output pixel, (image, oh, ow)
  const int c0 = (t - pix * runs) * VEC;
  const int img = pix / (OH * OW);
  const int r = pix - img * (OH * OW);
  const int oh = r / OW;
  const int ih0 = oh * stride - pad, iw0 = (r - oh * OW) * stride - pad;

  // the 9 * VEC weight bytes of channels c0 .. c0+VEC-1: channel j's tap
  // q is byte 9j + q (the weight is (C, 3, 3, 1), 9 bytes a channel)
  constexpr int NW = 9 * VEC / 4;
  uint32_t wv[NW];
  if constexpr (VEC == 16) {
    const int4* src = reinterpret_cast<const int4*>(w + (size_t)c0 * 9);
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const int4 v = __ldg(src + i);
      wv[4 * i] = v.x; wv[4 * i + 1] = v.y; wv[4 * i + 2] = v.z; wv[4 * i + 3] = v.w;
    }
  } else {
    const int* src = reinterpret_cast<const int*>(w + (size_t)c0 * 9);
#pragma unroll
    for (int i = 0; i < NW; ++i) wv[i] = __ldg(src + i);
  }

  int acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0;
  const int8_t* xb = x + (size_t)img * H * W * C + c0;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int ih = ih0 + q / 3, iw = iw0 + q % 3;
    if ((unsigned)ih >= (unsigned)H || (unsigned)iw >= (unsigned)W) continue;
    const int8_t* src = xb + ((size_t)ih * W + iw) * C;
    uint32_t xv[VEC / 4];
    if constexpr (VEC == 16) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(src));
      xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
    } else {
      xv[0] = __ldg(reinterpret_cast<const int*>(src));
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int b = 9 * j + q;
      acc[j] += sbyte(xv[j / 4], j % 4) * sbyte(wv[b / 4], b % 4);
    }
  }
  int4* dst = reinterpret_cast<int4*>(out + (size_t)pix * C + c0);
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i)
    dst[i] = make_int4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
}

int launch_dw(cudaStream_t s, const void* x, const void* w, void* out, int N,
              int H, int W, int C, int OH, int OW, int stride, int pad) {
  const int vec = C % 16 == 0 ? 16 : 4;
  const int total = N * OH * OW * (C / vec);
  const dim3 grid((total + THREADS - 1) / THREADS);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int32_t* op = static_cast<int32_t*>(out);
  if (vec == 16)
    conv_s8_dw_kernel<16><<<grid, THREADS, 0, s>>>(xp, wp, op, H, W, C, OH, OW, stride, pad, total);
  else
    conv_s8_dw_kernel<4><<<grid, THREADS, 0, s>>>(xp, wp, op, H, W, C, OH, OW, stride, pad, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). Launches on `stream` and returns the
// CUDA error as an int; it never synchronizes. The caller has checked: x
// (N, H, W, C) and w (O, ks, ks, C / groups) int8 and out (N, OH, OW, O)
// int32, all contiguous and 16-byte aligned; ks in {1, 3}; O a multiple of
// 8; N*OH*OW*O and N*H*W*C below 2**31; K = ks*ks*C / groups small enough
// that no int32 sum overflows. groups = C (= O, ks = 3, C a multiple of 4)
// runs the depthwise kernel. Else C is a power of two >= 4 and the plan is
// the wrapper's `_conv_plan`, which carries the route: bn = 0 runs the
// __dp4a kernel; bn = 128 (O a multiple of 128) or 64 runs the tensor-core
// kernel, which takes C >= 16, in `splits` (1..8) runs of `per_split`
// stages of K covering them all.
extern "C" int facekit_conv_s8(const void* x, const void* w, void* out,
                               int N, int H, int W, int C, int O, int ks,
                               int stride, int pad, int OH, int OW, int groups,
                               int bn, int splits, int per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups > 1) {
    if (groups != C || O != C || ks != 3 || C % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_dw(s, x, w, out, N, H, W, C, OH, OW, stride, pad);
  }
  if (C < 4 || (C & (C - 1)) || O % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int log2_c = __builtin_ctz(static_cast<unsigned>(C));
  const int M = N * OH * OW;
  if (bn == 0) {
    return ks == 1 ? launch_dp4a<1>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M)
                   : launch_dp4a<3>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M);
  }
  if (log2_c < 4 || splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ks == 1)
    return bn == 128 ? launch_mma<1, 128>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M, splits, per_split)
                     : launch_mma<1, 64>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M, splits, per_split);
  return bn == 128 ? launch_mma<3, 128>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M, splits, per_split)
                   : launch_mma<3, 64>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M, splits, per_split);
}
