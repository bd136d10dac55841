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
// Both dtypes share the blocking:
//  * A cluster of G = C/64 CTAs per (image, band of R = 4 output rows); CTA
//    g of the cluster owns output channels 64g .. 64g+63 of both convs, so
//    every IR-50 shape at batch 8 launches 112-128 CTAs. Each CTA builds t
//    for the R+4 image rows the band needs, all C channels, in shared
//    memory (zero rows outside the image, zero columns either side), and
//    computes its 64 channels of u on the R+2 rows conv2 needs into its own
//    shared memory (rounded to the dtype, zero rows outside the image).
//    conv1 on the halo rows is computed by both neighbouring bands:
//    (R+2)/R of conv1's work.
//  * Each conv is an implicit GEMM from shared memory: the band's pixels x
//    the CTA's 64 output channels, K = 9*C in the weight's (kh, kw, c)
//    order, so a K stage is channels of one tap.
//
// bf16 (ir_block_bf16_kernel): warp-level tensor cores, mma.sync m16n8k16
// bf16 -> f32 (bf16 products are exact in f32, as in the plain version;
// only the order of the sums differs).
//  * A band's pixels are split into m16 tiles. The 8 warps are WM (pixels)
//    x 2 (32 channels each) x WK = 4/WM (split-K over the k16 steps of a
//    stage), WM chosen per conv so that a warp holds 2-3 tiles (MT at
//    most): 56x56 and 28x28 run WM = 4, 14x14 and 7x7 WM = 2 or 1, and the
//    WK groups' sums meet in shared memory at the end. One tile per warp
//    left the tensor cores waiting on the latency of each warp's mma chain.
//  * A comes from the band with ldmatrix.x4: each lane passes the address of
//    its own pixel row shifted by the tap, so the implicit-GEMM gather of a
//    3x3 tap costs nothing. B: the weights (O, 3, 3, C) are K-contiguous per
//    output channel, the .col layout; 64 x 64 bf16 stages (one tap, 64
//    input channels) stream from L2 with cp.async.cg into a ring of NST = 3
//    buffers, two stages ahead, one __syncthreads per stage.
//  * conv2 reads its own shared memory (ldmatrix takes no other CTA's):
//    after a cluster barrier each CTA copies all C channels of u on its R+2
//    rows from the cluster's G CTAs into the t band's space, in 16-byte
//    loads; a second cluster barrier, then conv2 runs like conv1. w2's first
//    stages load while the copy runs.
//  * Band pixels and weight rows are padded by 8 bf16 (16 bytes), so the 8
//    row addresses of an ldmatrix fall in distinct bank groups.
//  * Two CTAs fit on an SM at 14x14x256 and 7x7x512 (109 and 110 KB of
//    shared memory, at most 128 registers): with one, only 30 clusters of 4
//    (15 of 8) are resident, and batch 8 (32 and 16 clusters) took two
//    waves. 56x56x64 and 28x28x128 take 145 and 119 KB, one CTA per SM.
// f32 (ir_block_kernel): CUDA-core FMAs (TF32 would change its numerics).
// Each of 256 threads accumulates a 4-pixel x 4-channel micro-tile of a
// 64-pixel tile; 32 x 64 f32 weight stages through registers; conv2 reads u
// from the cluster's CTAs through distributed shared memory; up to 211 KB
// of shared memory (56x56x64).
//
// Left for later: wgmma and TMA for the bf16 path (a 64-row warpgroup tile,
// weights multicast across the cluster), and the f32 path on anything but
// CUDA cores.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TM = 64;   // pixels per tile
constexpr int TN = 64;   // output channels per tile
constexpr int KC = 32;   // K per weight stage

__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// two consecutive elements (8- or 4-byte aligned) as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// four consecutive elements of global memory as floats
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

// ---- bf16: warp-level tensor cores -----------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int NST = 3;            // weight stages in the ring
constexpr int KS = 64;            // K per weight stage: 64 channels of one tap
constexpr int WSTR = KS + 8;      // row stride (bf16) of a weight stage
constexpr int USTR = TN + 8;      // pixel stride (bf16) of a CTA's u slice
constexpr int MT = 3;             // m16 tiles a warp holds at once (x 4 n8 tiles)
constexpr int RSTR = TN + 8;      // row stride (f32) of the split-K partial sums
static_assert(TN * KS / 8 == 2 * THREADS, "two 16-byte chunks per thread");

// WM of a conv with `mtiles` m16 tiles: its 8 warps are WM (pixels) x 2 (32
// channels each) x WK = 4/WM (k16 steps of a stage, split-K). With WK > 1
// the conv has one pass.
__host__ __device__ __forceinline__ int warps_m(int mtiles) {
  return mtiles > 2 * MT ? 4 : (mtiles > MT ? 2 : 1);
}

// Bytes of the band region: the t band (R+4, W+2, C+8) bf16, which later
// holds conv2's copy of u, and at the end of each conv the split-K partial
// sums (WK-1 groups of all its rows, f32), when they need more.
__host__ __device__ __forceinline__ size_t band_bytes(int R, int W, int C) {
  size_t bytes = (size_t)(R + 4) * (W + 2) * (C + 8) * 2;
  for (int rows = R; rows <= R + 2; rows += 2) {
    const int mtiles = (rows * W + 15) / 16;
    const size_t part = (size_t)(4 / warps_m(mtiles) - 1) * mtiles * 16 * RSTR * 4;
    bytes = part > bytes ? part : bytes;
  }
  return (bytes + 15) / 16 * 16;
}

// two bf16 of a 32-bit word (the lower address in the low half) as floats,
// and two floats rounded to nearest into one word
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(h.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(h.y)) << 16);
}

// This thread's share of a conv's weight stages (64 output channels x 64 K,
// 512 chunks of 16 bytes): rows tid/8 and tid/8 + 32, chunk tid%8, eight
// threads per 128-byte row.
struct WeightStream {
  const bf16* src;                // row tid/8, chunk tid%8 of stage 0
  size_t rows32;                  // 32 rows of w, in elements
  uint32_t dst;                   // the same in ring buffer 0
  __device__ WeightStream(const bf16* w, int K, int o_base, const bf16* ring) {
    const int row = threadIdx.x >> 3, ch = (threadIdx.x & 7) * 8;
    src = w + (size_t)(o_base + row) * K + ch;
    rows32 = (size_t)32 * K;
    dst = smem_u32(ring + row * WSTR + ch);
  }
  // starts the copy of stage s into ring buffer buf
  __device__ __forceinline__ void load(int s, int buf) const {
    const uint32_t d = dst + buf * (TN * WSTR * 2);
    cp_async16(d, src + s * KS);
    cp_async16(d + 32 * WSTR * 2, src + rows32 + s * KS);
  }
  // the first NST-1 stages, one commit group each
  __device__ __forceinline__ void prologue() const {
#pragma unroll
    for (int s = 0; s < NST - 1; ++s) {
      load(s, s);
      cp_async_commit();
    }
  }
};

// Starts pass `pass` of a conv for this warp: its m16 tiles are tile0 +
// WM*i for i < ntile (<= MT) of the pass's tiles [pass*per_pass,
// (pass+1)*per_pass) of all mtiles, wm its place among the WM warps along
// pixels. Sets the byte offsets (tap (0,0), this lane's 8 channels of A) of
// its pixel rows, where pixels past P read pixel 0 and are never stored, and
// clears the accumulators.
__device__ __forceinline__ void start_pass(uint32_t (&a_off)[MT],
                                           float (&acc)[MT][4][4], int& tile0,
                                           int& ntile, int wm, int WM, int pass,
                                           int per_pass, int mtiles, int P, int W,
                                           int CP) {
  const int lane = threadIdx.x & 31;
  const int t1 = min((pass + 1) * per_pass, mtiles);
  tile0 = pass * per_pass + wm;
  ntile = tile0 < t1 ? (t1 - tile0 + WM - 1) / WM : 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int m = (tile0 + WM * i) * 16 + (lane & 15);
    if (m >= P) m = 0;
    a_off[i] = (uint32_t)(((m / W) * (W + 2) + m % W) * CP + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  }
}

// One 3x3 conv over `rows` output rows of the band in shared memory (rows of
// W+2 pixels of pixel stride CP bf16, zero columns at 0 and W+1), for the
// CTA's TN output channels, as an implicit GEMM on tensor cores. The caller
// has started ws.prologue(). Calls epi(m, n, v0, v1) with the f32 sums of
// band pixel m (m < rows*W; row m / W, column m % W) for channels n and n+1
// (n even, < TN). With split-K the partial sums go through the band, so the
// caller's band is dead when this returns.
template <typename Epi>
__device__ __forceinline__ void conv_mma(bf16* band, int CP, const WeightStream& ws,
                                         const bf16* ring, int rows, int W, int C,
                                         Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W2 = W + 2;
  const int S = 9 * C / KS;                        // stages per pass
  const int P = rows * W;
  const int mtiles = (P + 15) / 16;
  const int WM = warps_m(mtiles);
  const int WK = 4 / WM;
  const int wm = warp % WM;
  const int wn = (warp / WM) % 2;                  // channels wn*32 .. +31
  const int wk = warp / (2 * WM);                  // k16 steps wk, wk+WK, ..
  const int passes = (mtiles + WM * MT - 1) / (WM * MT);
  const int per_pass = (mtiles + passes - 1) / passes;
  const int total = passes * S;
  const uint32_t band_s = smem_u32(band);
  // B: lanes 0-7 / 8-15 / 16-23 / 24-31 address n-tile 0 k 0-7 / n-tile 0
  // k 8-15 / n-tile 1 k 0-7 / n-tile 1 k 8-15 of a pair of n8 tiles
  const uint32_t b_lane = smem_u32(ring) +
      (uint32_t)((wn * 32 + (lane & 7) + (lane >> 4) * 8) * WSTR +
                 ((lane >> 3) & 1) * 8) * 2;

  float acc[MT][4][4];
  uint32_t a_off[MT];
  int pass = 0, tile0, ntile;
  start_pass(a_off, acc, tile0, ntile, wm, WM, pass, per_pass, mtiles, P, W, CP);
  int s = 0, kh = 0, kw = 0, c0 = 0;               // stage gs: tap (kh, kw), c0..
  int buf = 0;                                     // its ring buffer
  int ld_s = NST - 1, ld_buf = NST - 1;            // the stage loaded next

  for (int gs = 0; gs < total; ++gs) {
    cp_async_wait<NST - 2>();                      // stage gs has landed
    __syncthreads();                               // ... for every thread, and
                                                   // stage gs-1 is consumed
    if (gs + NST - 1 < total) ws.load(ld_s, ld_buf);
    cp_async_commit();
    if (++ld_s == S) ld_s = 0;
    if (++ld_buf == NST) ld_buf = 0;

    const uint32_t a_tap = band_s + (uint32_t)(((kh * W2 + kw) * CP + c0) * 2);
    const uint32_t b_st = b_lane + (uint32_t)(buf * TN * WSTR * 2);
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      if ((kk & (WK - 1)) != wk) continue;
      uint32_t b[4][2], r[4];
      ldmatrix_x4(r, b_st + kk * 32);
      b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
      ldmatrix_x4(r, b_st + 16 * WSTR * 2 + kk * 32);
      b[2][0] = r[0]; b[2][1] = r[1]; b[3][0] = r[2]; b[3][1] = r[3];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < ntile) {
          uint32_t a[4];
          ldmatrix_x4(a, a_tap + a_off[i] + kk * 32);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
    }
    if (++buf == NST) buf = 0;
    if ((c0 += KS) == C) {
      c0 = 0;
      if (++kw == 3) { kw = 0; ++kh; }
    }
    if (++s < S) continue;

    // the pass is done; lane l holds rows l/4 and l/4+8, columns 2(l%4) and
    // 2(l%4)+1 of each n8 tile
    s = kh = 0;
    if (WK > 1) {
      // split-K: groups wk > 0 leave their sums in the band, group 0 adds
      // them in the order of wk
      float* part = reinterpret_cast<float*>(band);
      __syncthreads();                             // the band is read
      if (wk > 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < ntile) {
            const int row = (WM * i + wm) * 16 + (lane >> 2);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float* q = part + ((wk - 1) * mtiles * 16 + row) * RSTR + wn * 32 +
                         j * 8 + (lane & 3) * 2;
              *reinterpret_cast<float2*>(q) = make_float2(acc[i][j][0], acc[i][j][1]);
              *reinterpret_cast<float2*>(q + 8 * RSTR) =
                  make_float2(acc[i][j][2], acc[i][j][3]);
            }
          }
        }
      }
      __syncthreads();
      if (wk == 0) {
        for (int g = 1; g < WK; ++g) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            if (i < ntile) {
              const int row = (WM * i + wm) * 16 + (lane >> 2);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float* q = part + ((g - 1) * mtiles * 16 + row) * RSTR +
                                 wn * 32 + j * 8 + (lane & 3) * 2;
                const float2 lo = *reinterpret_cast<const float2*>(q);
                const float2 hi = *reinterpret_cast<const float2*>(q + 8 * RSTR);
                acc[i][j][0] = __fadd_rn(acc[i][j][0], lo.x);
                acc[i][j][1] = __fadd_rn(acc[i][j][1], lo.y);
                acc[i][j][2] = __fadd_rn(acc[i][j][2], hi.x);
                acc[i][j][3] = __fadd_rn(acc[i][j][3], hi.y);
              }
            }
          }
        }
      }
    }
    if (wk == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < ntile) {
          const int m = (tile0 + WM * i) * 16 + (lane >> 2);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = wn * 32 + j * 8 + (lane & 3) * 2;
            if (m < P) epi(m, n, acc[i][j][0], acc[i][j][1]);
            if (m + 8 < P) epi(m + 8, n, acc[i][j][2], acc[i][j][3]);
          }
        }
      }
    }
    if (++pass < passes)
      start_pass(a_off, acc, tile0, ntile, wm, WM, pass, per_pass, mtiles, P, W, CP);
  }
}

// Grid and clusters as ir_block_kernel's.
template <int R>
__global__ void __launch_bounds__(THREADS, 2)
ir_block_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const bf16* __restrict__ w2, const float* __restrict__ par,
                     bf16* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = (int)cluster.block_rank();
  const int G = (int)cluster.num_blocks();
  const int W2 = W + 2;
  const int CP = C + 8;                            // pixel stride of the band
  bf16* band = reinterpret_cast<bf16*>(smem);      // (R+4, W+2, C+8): t, then u
  bf16* uslice = reinterpret_cast<bf16*>(smem + band_bytes(R, W, C));
  bf16* ring = uslice + (size_t)(R + 2) * W2 * USTR;  // NST x (TN, KS+8)

  const int n = blockIdx.y;
  const int r0 = (blockIdx.x / G) * R;
  const int o_base = g * TN;
  const int K = 9 * C;
  const bf16* xn = x + (size_t)n * H * W * C;
  const float* s1 = par;
  const float* b1 = par + C;
  const float* alpha = par + 2 * C + o_base;
  const float* s2 = par + 3 * C + o_base;
  const float* b2 = par + 4 * C + o_base;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  const WeightStream ws1(w1, K, o_base, ring), ws2(w2, K, o_base, ring);
  ws1.prologue();                                  // w1 loads while t builds

  // t = bf16(f32(x)*s1 + b1) on image rows r0-2 .. r0+R+1, all C channels,
  // 0 off the image; 8 channels (16 bytes) per step
  const int C8 = C / 8;
  for (int e = threadIdx.x; e < (R + 4) * W * C8; e += THREADS) {
    const int c = (e % C8) * 8;
    const int pix = e / C8;
    const int i = pix / W, col = pix - (pix / W) * W;
    const int gy = r0 - 2 + i;
    uint4 v = zero;
    if (gy >= 0 && gy < H) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(
          xn + ((size_t)gy * W + col) * C + c));
      const uint32_t xw[4] = {q.x, q.y, q.z, q.w};
      uint32_t tw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 xf = unpack_bf16x2(xw[k]);
        const float2 s = __ldg(reinterpret_cast<const float2*>(s1 + c + 2 * k));
        const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + c + 2 * k));
        tw[k] = pack_bf16x2(__fadd_rn(__fmul_rn(xf.x, s.x), b.x),
                            __fadd_rn(__fmul_rn(xf.y, s.y), b.y));
      }
      v = make_uint4(tw[0], tw[1], tw[2], tw[3]);
    }
    *reinterpret_cast<uint4*>(band + ((size_t)i * W2 + col + 1) * CP + c) = v;
  }
  // zero columns 0 and W+1 of the t band and of the u slice
  for (int e = threadIdx.x; e < (R + 4) * 2 * C8; e += THREADS) {
    const int i = e / (2 * C8);
    const int rem = e - i * 2 * C8;
    const int col = rem < C8 ? 0 : W + 1;
    *reinterpret_cast<uint4*>(band + ((size_t)i * W2 + col) * CP +
                              (rem % C8) * 8) = zero;
  }
  for (int e = threadIdx.x; e < (R + 2) * 2 * (TN / 8); e += THREADS) {
    const int i = e / (2 * (TN / 8));
    const int rem = e - i * 2 * (TN / 8);
    const int col = rem < TN / 8 ? 0 : W + 1;
    *reinterpret_cast<uint4*>(uslice + ((size_t)i * W2 + col) * USTR +
                              (rem % (TN / 8)) * 8) = zero;
  }
  // (conv_mma's first __syncthreads publishes t)

  // u on image rows r0-1 .. r0+R, this CTA's channels: prelu of conv1,
  // rounded, 0 off the image
  conv_mma(band, CP, ws1, ring, R + 2, W, C,
           [&](int m, int c, float v0, float v1) {
             const int i = m / W, col = m - (m / W) * W;
             const int gy = r0 - 1 + i;
             float2 u = make_float2(0.f, 0.f);
             if (gy >= 0 && gy < H) {
               const float2 a = __ldg(reinterpret_cast<const float2*>(alpha + c));
               u.x = v0 > 0.f ? v0 : __fmul_rn(v0, a.x);
               u.y = v1 > 0.f ? v1 : __fmul_rn(v1, a.y);
             }
             *reinterpret_cast<__nv_bfloat162*>(
                 uslice + ((size_t)i * W2 + col + 1) * USTR + c) =
                 __floats2bfloat162_rn(u.x, u.y);
           });
  cluster.sync();                   // every u slice is written; the ring and
                                    // the t band are free
  ws2.prologue();                   // w2 loads while u is gathered

  // all C channels of u on the R+2 rows (zero columns included) from the
  // cluster's CTAs into the band, 16 bytes per step
  for (int e = threadIdx.x; e < (R + 2) * W2 * C8; e += THREADS) {
    const int c = (e % C8) * 8;
    const int pix = e / C8;
    const bf16* src = cluster.map_shared_rank(uslice, c / TN);
    *reinterpret_cast<uint4*>(band + (size_t)pix * CP + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)pix * USTR + c % TN);
  }
  cluster.sync();                   // the cluster is done with every u slice

  // out on image rows r0 .. r0+R-1, this CTA's channels: bn2 of conv2 plus x
  bf16* on = out + (size_t)n * H * W * C;
  conv_mma(band, CP, ws2, ring, R, W, C,
           [&](int m, int c, float v0, float v1) {
             const int i = m / W, col = m - (m / W) * W;
             const int gy = r0 + i;
             if (gy >= H) return;
             const size_t off = ((size_t)gy * W + col) * C + o_base + c;
             const float2 res = __bfloat1622float2(
                 *reinterpret_cast<const __nv_bfloat162*>(xn + off));
             const float2 s = __ldg(reinterpret_cast<const float2*>(s2 + c));
             const float2 b = __ldg(reinterpret_cast<const float2*>(b2 + c));
             *reinterpret_cast<__nv_bfloat162*>(on + off) = __floats2bfloat162_rn(
                 __fadd_rn(__fadd_rn(__fmul_rn(v0, s.x), b.x), res.x),
                 __fadd_rn(__fadd_rn(__fmul_rn(v1, s.y), b.y), res.y));
           });
}

// Sets the kernel's shared memory and launches it on (bands * G, N) CTAs in
// clusters of G = C / TN along x.
template <typename T, typename Kernel>
int launch_clusters(Kernel kernel, size_t smem, cudaStream_t s, const void* x,
                    const void* w1, const void* w2, const float* par, void* out,
                    int N, int H, int W, int C, int R) {
  const int G = C / TN;
  cudaError_t err = cudaFuncSetAttribute(kernel,
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
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const T*>(w1), static_cast<const T*>(w2), par,
                           static_cast<T*>(out), H, W, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_bf16(cudaStream_t s, const void* x, const void* w1, const void* w2,
                const float* par, void* out, int N, int H, int W, int C) {
  const size_t smem = band_bytes(R, W, C) +
                      ((size_t)(R + 2) * (W + 2) * USTR + (size_t)NST * TN * WSTR) *
                          sizeof(bf16);
  return launch_clusters<bf16>(ir_block_bf16_kernel<R>, smem, s, x, w1, w2, par,
                               out, N, H, W, C, R);
}

template <int R>
int launch_f32(cudaStream_t s, const void* x, const void* w1, const void* w2,
               const float* par, void* out, int N, int H, int W, int C) {
  const size_t smem = ((size_t)(R + 4) * (W + 2) * C +
                       (size_t)(R + 2) * (W + 2) * TN + (size_t)KC * TN) *
                      sizeof(float);
  return launch_clusters<float>(ir_block_kernel<float, R>, smem, s, x, w1, w2, par,
                                out, N, H, W, C, R);
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
  if (dtype == 1) return launch_bf16<4>(s, x, w1, w2, p, out, N, H, W, C);
  return launch_f32<4>(s, x, w1, w2, p, out, N, H, W, C);
}
