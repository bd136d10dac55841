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
// 3.2 MB, 0.001 ms), and in f32 at three TF32 products per f32 product
// (3xTF32, below). chip_smoke.py computes the bound of every case it runs.
//
// Both dtypes share the blocking:
//  * A cluster of G = C/64 CTAs per (image, band of R output rows); CTA g
//    of the cluster owns output channels 64g .. 64g+63 of both convs, so
//    every IR-50 shape at batch 8 launches 112-128 CTAs in bf16 (64-112
//    in f32, whose R differs). Each CTA builds t
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
// bf16 (ir_block_bf16_kernel, R = 4): warp-level tensor cores, mma.sync
// m16n8k16 bf16 -> f32 (bf16 products are exact in f32, as in the plain
// version; only the order of the sums differs).
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
// f32 (ir_block_f32_kernel): the same tensor cores as 3xTF32, mma.sync
// m16n8k8 tf32 -> f32 (the f32 gallery search's scheme, topk_mma.cuh). One
// TF32 product keeps 11 bits of each operand, which would miss the plain
// version's f32 convs by about 1e-3; so each operand splits into hi + lo
// and lo*hi + hi*lo + hi*hi go into the accumulator, small terms first,
// about 21 bits of each product.
//  * conv_tf32 is conv_mma with 4-byte elements. An 8x8 b16 ldmatrix tile
//    of K-contiguous f32 is the 8x4 tf32 fragment m16n8k8 takes, so A
//    (band pixels, C+4 floats apart) and B (weight rows, 256 + 16 bytes
//    apart) load with the same ldmatrix.x4 addresses, in bytes, as bf16's.
//    A stage is 64 channels of one tap, eight k8 steps, 24 mma per
//    (m16, n8) tile, in a ring of two (a third bought nothing) whose
//    256-byte rows are unpadded, each 16-byte chunk c of row n at c ^ (n %
//    8), so that 8 row addresses still fall in distinct bank groups; t, u
//    and the weights are split in registers after each ldmatrix
//    (split_tf32_trunc: hi = the top 19 bits, lo = x - hi, one integer
//    and one FP32 operation; Veltkamp's split_tf32, four FP32 ones, was
//    slower here). Weights split once on the host instead doubled the
//    weight stream and were slower at every shape (PERF.md, PR 19).
//  * The tensor cores round toward zero as they accumulate: a chain of
//    3*9*C/8 mma (1,728 at C = 512) drifts by ulps of the sum each step,
//    past 1e-4 of the output. Each stage sums into a fresh accumulator,
//    then added to the pixel's, rounded to nearest.
//  * Only rows in the image are computed: conv1 skips u's row above the
//    first band and those below the image in the last, conv2 output rows
//    past H; those u rows are zeroed instead. t is built with cp.async
//    (all of x's rows in flight), then the BN affine in place.
//  * Shared memory is twice bf16's per element, so one CTA per SM at
//    every shape (two would need 113 KB each, below the t band alone at
//    14x14x256 and 7x7x512: 163 KB). At C = 64 (G = 1) conv1 writes u
//    straight into the band, u row y over t row y-2, which no later pass
//    of conv1 reads (every pass ends with a __syncthreads); the band has
//    R+5 rows. With G > 1 the band holds only the rows conv1 reads, each
//    CTA's u goes to its u slice (no zero columns) and is gathered into
//    the band as bf16 does. The split-K partial sums use the weight ring
//    (at most 2 groups along K, so that they fit). R is 7 at 14x14x256
//    and 7x7x512 (two bands an image and one: conv1's halo 9/7, and half
//    the clusters of R = 4, each with twice the pixels, so a stage's fixed
//    cost is shared by twice the mma) and 4 at 56x56x64 and 28x28x128;
//    lower where a band would not fit (f32_band_height). Shared memory per
//    CTA: 56x56x64 171 KB, 28x28x128 198 KB, 14x14x256 226 KB, 7x7x512
//    211 KB.
//
// Left for later: wgmma and TMA for both paths (a 64-row warpgroup tile,
// weights multicast across the cluster; wgmma takes tf32 at the full
// tensor-core rate, which mma.sync does not reach).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TN = 64;   // output channels per CTA

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

// ---- f32: 3xTF32 on warp-level tensor cores --------------------------------

constexpr int FCH = 64;                     // floats of a weight row per stage
constexpr int FNST = 2;                     // weight stages in the ring
constexpr uint32_t FSTAGE = TN * FCH * 4;   // bytes of one ring buffer
constexpr int PSTR = TN + 4;                // row stride (f32) of the partial sums
static_assert(TN * FCH / 4 == 4 * THREADS, "four 16-byte chunks per thread");
static_assert(THREADS % 128 == 0, "C/4 (16 to 128) divides THREADS");

// WM of an f32 conv with `mtiles` m16 tiles, as warps_m but at least 2, so
// that the split-K partial sums (WK-1 groups) fit in the ring
__host__ __device__ __forceinline__ int warps_m_f32(int mtiles) {
  return mtiles > 2 * MT ? 4 : 2;
}

// Rows of the f32 kernel's band: with G = 1, R+5 (u written over t, see
// ir_block_f32_kernel); with G > 1 the most any band's conv1 reads, t on
// its rows y1-1 .. y1e, which also holds the u rows conv2 reads. And of a
// u slice (G > 1): the u rows conv2 reads, r0-1 .. y2e.
__host__ __device__ __forceinline__ int f32_band_rows(int R, int H, int C) {
  if (C == TN) return R + 5;
  int rows = 0;
  for (int r0 = 0; r0 < H; r0 += R)
    rows = max(rows, min(r0 + R + 1, H) - max(r0 - 1, 0) + 2);
  return rows;
}
__host__ __device__ __forceinline__ int f32_urows(int R, int H) {
  int rows = 0;
  for (int r0 = 0; r0 < H; r0 += R) rows = max(rows, min(r0 + R, H) - r0 + 2);
  return rows;
}

// Shared memory of the f32 kernel, in this order: the band (rows, W+2,
// C+4) f32; with G > 1 the CTA's u slice (rows, W, TN), no zero columns;
// the weight ring, which at the end of a conv with split-K also holds the
// partial sums.
__host__ __device__ __forceinline__ size_t f32_band_bytes(int R, int H, int W, int C) {
  return (size_t)f32_band_rows(R, H, C) * (W + 2) * (C + 4) * 4;
}
__host__ __device__ __forceinline__ size_t f32_uslice_bytes(int R, int H, int W, int C) {
  return C > TN ? (size_t)f32_urows(R, H) * W * TN * 4 : 0;
}
__host__ __device__ __forceinline__ size_t f32_ring_bytes(int R, int W) {
  size_t bytes = (size_t)FNST * FSTAGE;
  for (int rows = 1; rows <= R + 2; ++rows) {      // the bands at the edges run fewer
    const int mtiles = (rows * W + 15) / 16;
    const size_t part = (size_t)(4 / warps_m_f32(mtiles) - 1) * mtiles * 16 * PSTR * 4;
    bytes = part > bytes ? part : bytes;
  }
  return bytes;
}

// This thread's share of a conv's weight stages (64 output channels x 256
// bytes of K, 1,024 chunks of 16 bytes): rows tid/16 + 16r (r < 4), chunk
// tid%16. A weight row holds K floats. A stage's rows are 256 bytes,
// unpadded: chunk c of row n lies at chunk c ^ (n % 8), so the 8 row
// addresses of an ldmatrix fall in distinct bank groups.
struct WeightStreamF32 {
  const float* src;
  size_t rows16;                  // 16 rows of w, in elements
  uint32_t dst;
  __device__ WeightStreamF32(const float* w, int K, int o_base, const float* ring) {
    const int row = threadIdx.x >> 4, ch = threadIdx.x & 15;
    src = w + (size_t)(o_base + row) * K + ch * 4;
    rows16 = (size_t)16 * K;
    dst = smem_u32(ring + row * FCH + (ch ^ (row & 7)) * 4);
  }
  // starts the copy of stage s into ring buffer buf
  __device__ __forceinline__ void load(int s, int buf) const {
    const uint32_t d = dst + buf * FSTAGE;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cp_async16(d + r * 16 * FCH * 4, src + r * rows16 + s * FCH);
  }
  // the first FNST-1 stages, one commit group each
  __device__ __forceinline__ void prologue() const {
#pragma unroll
    for (int s = 0; s < FNST - 1; ++s) {
      load(s, s);
      cp_async_commit();
    }
  }
};

// conv_mma's implicit GEMM in f32 as 3xTF32, over `rows` output rows of
// the band from `band` on (pixel stride CP floats, zero columns at 0 and
// W+1). A stage is 64 channels of one tap, eight k8 steps. The warps split
// as conv_mma's, split-K over the k8 steps of a stage in turn. Every pass
// ends with a __syncthreads, after which the band and the ring are no
// longer read; the split-K partial sums then go through the ring. Calls
// epi(m, n, v0, v1) as conv_mma does.
template <typename Epi>
__device__ __forceinline__ void conv_tf32(const float* band, int CP,
                                          const WeightStreamF32& ws, float* ring,
                                          int rows, int W, int C, Epi epi) {
  constexpr int KSTEP = FCH / 8;                   // k8 steps per stage
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W2 = W + 2;
  const int S = 9 * C / FCH;                       // stages per pass
  const int P = rows * W;
  const int mtiles = (P + 15) / 16;
  const int WM = warps_m_f32(mtiles);
  const int WK = 4 / WM;
  const int wm = warp % WM;
  const int wn = (warp / WM) % 2;                  // channels wn*32 .. +31
  const int wk = warp / (2 * WM);                  // k8 steps wk, wk+WK, ..
  const int passes = (mtiles + WM * MT - 1) / (WM * MT);
  const int per_pass = (mtiles + passes - 1) / passes;
  const int total = passes * S;
  const uint32_t band_s = smem_u32(band);
  // B: as conv_mma's, 16 bytes (4 floats of K) per 8x8 b16 matrix: this
  // lane's row of the stage and the swizzle of its chunk 2*kk + (lane/8)%2
  const uint32_t b_lane = smem_u32(ring) +
      (uint32_t)(wn * 32 + (lane & 7) + (lane >> 4) * 8) * FCH * 4;
  const uint32_t b_swz = ((lane >> 3) & 1) ^ (lane & 7);

  float acc[MT][4][4];
  uint32_t a_off[MT];
  int pass = 0, tile0, ntile;
  // start_pass counts in bf16 units: a pixel is 2*CP of them
  start_pass(a_off, acc, tile0, ntile, wm, WM, pass, per_pass, mtiles, P, W, 2 * CP);
  int s = 0, kh = 0, kw = 0, c0 = 0;               // stage gs: tap (kh, kw), c0..
  int buf = 0;                                     // its ring buffer
  int ld_s = FNST - 1, ld_buf = FNST - 1;          // the stage loaded next

  for (int gs = 0; gs < total; ++gs) {
    cp_async_wait<FNST - 2>();                     // stage gs has landed
    __syncthreads();                               // ... for every thread, and
                                                   // stage gs-1 is consumed
    if (gs + FNST - 1 < total) ws.load(ld_s, ld_buf);
    cp_async_commit();
    if (++ld_s == S) ld_s = 0;
    if (++ld_buf == FNST) ld_buf = 0;

    const uint32_t a_tap = band_s + (uint32_t)(((kh * W2 + kw) * CP + c0) * 4);
    const uint32_t b_st = b_lane + (uint32_t)buf * FSTAGE;
    // this stage's sums, added to acc rounded to nearest once the stage is
    // done (the tensor cores round toward zero as they accumulate)
    float part_s[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part_s[i][j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEP; ++kk) {
      if (((s * KSTEP + kk) & (WK - 1)) != wk) continue;
      uint32_t bh[4][2], bl[4][2], r[4], ar[MT][4];
      const uint32_t b_k = b_st + (((2 * kk) ^ b_swz) << 4);
      ldmatrix_x4(r, b_k);
      bh[0][0] = r[0]; bh[0][1] = r[1]; bh[1][0] = r[2]; bh[1][1] = r[3];
      ldmatrix_x4(r, b_k + 16 * FCH * 4);
      bh[2][0] = r[0]; bh[2][1] = r[1]; bh[3][0] = r[2]; bh[3][1] = r[3];
      // every A of the step before the first mma
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (i < ntile) ldmatrix_x4(ar[i], a_tap + a_off[i] + kk * 32);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) split_tf32_trunc(bh[j][h], bh[j][h], bl[j][h]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < ntile) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32_trunc(ar[i][q], ah[q], al[q]);
          // 3xTF32, the small terms first
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_tf32(part_s[i][j], al, bh[j][0], bh[j][1]);
            mma_tf32(part_s[i][j], ah, bl[j][0], bl[j][1]);
            mma_tf32(part_s[i][j], ah, bh[j][0], bh[j][1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[i][j][q] = __fadd_rn(acc[i][j][q], part_s[i][j][q]);
    if (++buf == FNST) buf = 0;
    if ((c0 += FCH) == C) {
      c0 = 0;
      if (++kw == 3) { kw = 0; ++kh; }
    }
    if (++s < S) continue;

    // the pass is done; lane l holds rows l/4 and l/4+8, columns 2(l%4) and
    // 2(l%4)+1 of each n8 tile
    s = kh = 0;
    __syncthreads();                               // the band is read
    if (WK > 1) {
      // split-K (one pass, so the ring is free): groups wk > 0 leave their
      // sums in the ring, group 0 adds them in the order of wk
      if (wk > 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < ntile) {
            const int row = (WM * i + wm) * 16 + (lane >> 2);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float* q = ring + ((wk - 1) * mtiles * 16 + row) * PSTR + wn * 32 +
                         j * 8 + (lane & 3) * 2;
              *reinterpret_cast<float2*>(q) = make_float2(acc[i][j][0], acc[i][j][1]);
              *reinterpret_cast<float2*>(q + 8 * PSTR) =
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
                const float* q = ring + ((g - 1) * mtiles * 16 + row) * PSTR +
                                 wn * 32 + j * 8 + (lane & 3) * 2;
                const float2 lo = *reinterpret_cast<const float2*>(q);
                const float2 hi = *reinterpret_cast<const float2*>(q + 8 * PSTR);
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
      start_pass(a_off, acc, tile0, ntile, wm, WM, pass, per_pass, mtiles, P, W, 2 * CP);
  }
}

// Grid and clusters as ir_block_bf16_kernel's; the band height R is
// H / bands rounded up (f32_band_height).
__global__ void __launch_bounds__(THREADS, 1)
ir_block_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ w2, const float* __restrict__ par,
                    float* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = (int)cluster.block_rank();
  const int G = (int)cluster.num_blocks();
  const int bands = (int)gridDim.x / G;
  const int R = (H + bands - 1) / bands;
  const int W2 = W + 2;
  const int CP = C + 4;                            // pixel stride of the band
  float* band = reinterpret_cast<float*>(smem);
  float* uslice = reinterpret_cast<float*>(smem + f32_band_bytes(R, H, W, C));
  float* ring = reinterpret_cast<float*>(smem + f32_band_bytes(R, H, W, C) +
                                         f32_uslice_bytes(R, H, W, C));

  const int n = blockIdx.y;
  const int r0 = (blockIdx.x / G) * R;
  // conv1 computes u on image rows y1 .. y1e-1 (those of r0-1 .. r0+R in
  // the image), conv2 the output on rows r0 .. y2e-1; u rows off the
  // image are 0
  const int y1 = max(r0 - 1, 0), y1e = min(r0 + R + 1, H), y2e = min(r0 + R, H);
  // u row y - (r0-1) sits on band row (G = 1) or u slice row (G > 1)
  // y - (r0-1). With G = 1 conv1 writes u straight into the band, u row y
  // over t row y-2, which no later pass of conv1 reads (a pass's rows end
  // where the next pass's begin): t on image rows r0-2 .. r0+R+1 from band
  // row 1. With G > 1, t on the rows conv1 reads, y1-1 .. y1e, from band
  // row 0, and conv2's u gathered over them.
  // the CTA's u at u row i, image column col
  auto u_at = [&](int i, int col) {
    return G > 1 ? uslice + ((size_t)i * W + col) * TN
                 : band + ((size_t)i * W2 + col + 1) * CP;
  };
  const int trow = G > 1 ? 0 : 1;                  // the band row of t's first
  const int tb = G > 1 ? y1 - 1 : r0 - 2, te = G > 1 ? y1e + 1 : r0 + R + 2;
  const int o_base = g * TN;
  const float* xn = x + (size_t)n * H * W * C;
  const float* s1 = par;
  const float* b1 = par + C;
  const float* alpha = par + 2 * C + o_base;
  const float* s2 = par + 3 * C + o_base;
  const float* b2 = par + 4 * C + o_base;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const int K = 9 * C;
  const WeightStreamF32 ws1(w1, K, o_base, ring), ws2(w2, K, o_base, ring);
  ws1.prologue();                                  // w1 loads while t builds

  // x on image rows tb .. te-1, all C channels, 0 off the image, copied
  // with cp.async (16 bytes each, all in flight); then t = f32(x)*s1 + b1
  // in place on the image rows. C/4 divides THREADS, so a thread's 4
  // channels (16 bytes) are the same at every step.
  const int C4 = C / 4;
  const int c4 = (threadIdx.x % C4) * 4;
  for (int pix = threadIdx.x / C4; pix < (te - tb) * W; pix += THREADS / C4) {
    const int i = pix / W, col = pix - (pix / W) * W;
    const int gy = tb + i;
    const bool in = gy >= 0 && gy < H;
    cp_async16_zfill(smem_u32(band + ((size_t)(i + trow) * W2 + col + 1) * CP + c4),
                     in ? xn + ((size_t)gy * W + col) * C + c4 : xn, in);
  }
  cp_async_commit();
  // zero columns 0 and W+1 of every band row
  for (int e = threadIdx.x; e < (te - tb + trow) * 2 * C4; e += THREADS) {
    const int i = e / (2 * C4);
    const int rem = e - i * 2 * C4;
    const int col = rem < C4 ? 0 : W + 1;
    *reinterpret_cast<float4*>(band + ((size_t)i * W2 + col) * CP + (rem % C4) * 4) =
        zero;
  }
  cp_async_wait<0>();
  __syncthreads();
  const int t0 = max(tb, 0), t1 = min(te, H);     // x's image rows
  const float4 sc = __ldg(reinterpret_cast<const float4*>(s1 + c4));
  const float4 sh = __ldg(reinterpret_cast<const float4*>(b1 + c4));
  for (int pix = threadIdx.x / C4; pix < (t1 - t0) * W; pix += THREADS / C4) {
    const int i = pix / W, col = pix - (pix / W) * W;
    float4* p = reinterpret_cast<float4*>(
        band + ((size_t)(t0 - tb + trow + i) * W2 + col + 1) * CP + c4);
    const float4 q = *p;
    *p = make_float4(__fadd_rn(__fmul_rn(q.x, sc.x), sh.x),
                     __fadd_rn(__fmul_rn(q.y, sc.y), sh.y),
                     __fadd_rn(__fmul_rn(q.z, sc.z), sh.z),
                     __fadd_rn(__fmul_rn(q.w, sc.w), sh.w));
  }
  // (conv_tf32's first __syncthreads publishes t)

  // u on image rows y1 .. y1e-1, this CTA's channels: prelu of conv1
  conv_tf32(band + (size_t)(trow + y1 - 1 - tb) * W2 * CP, CP, ws1, ring, y1e - y1, W, C,
            [&](int m, int c, float v0, float v1) {
              const int i = m / W, col = m - (m / W) * W;
              const float2 a = __ldg(reinterpret_cast<const float2*>(alpha + c));
              *reinterpret_cast<float2*>(u_at(y1 - r0 + 1 + i, col) + c) =
                  make_float2(v0 > 0.f ? v0 : __fmul_rn(v0, a.x),
                              v1 > 0.f ? v1 : __fmul_rn(v1, a.y));
            });
  // the u rows conv2 reads off the image: r0-1 in the first band, H in the
  // last (with G = 1 these band rows still hold x or nothing)
  for (int e = threadIdx.x; e < (y2e - r0 + 2) * W * (TN / 4); e += THREADS) {
    const int c = (e % (TN / 4)) * 4;
    const int pix = e / (TN / 4);
    const int i = pix / W, col = pix - (pix / W) * W;
    const int gy = r0 - 1 + i;
    if (gy < 0 || gy >= y1e) *reinterpret_cast<float4*>(u_at(i, col) + c) = zero;
  }
  cluster.sync();                   // every u slice is written; the ring is free
  ws2.prologue();                   // w2 loads while u is gathered
  if (G > 1) {
    // all C channels of u on the rows conv2 reads from the cluster's CTAs
    // into band rows 0 .. (whose zero columns stay), 16 bytes per step,
    // four loads in flight; a thread's channels are those of one CTA
    const float* src = cluster.map_shared_rank(uslice, c4 / TN) + c4 % TN;
    float* dst = band + CP + c4;                   // column 1
    const int npix = (y2e - r0 + 2) * W, step = THREADS / C4;
    for (int p0 = threadIdx.x / C4; p0 < npix; p0 += 4 * step) {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (p0 + k * step < npix)
          v[k] = *reinterpret_cast<const float4*>(src + (size_t)(p0 + k * step) * TN);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + k * step;
        if (p < npix)
          *reinterpret_cast<float4*>(dst + (size_t)((p / W) * W2 + p % W) * CP) = v[k];
      }
    }
  }

  // out on image rows r0 .. y2e-1, this CTA's channels: bn2 of conv2 plus x
  // (the other CTAs may still read this CTA's u slice, which nothing
  // writes any more)
  float* on = out + (size_t)n * H * W * C;
  conv_tf32(band, CP, ws2, ring, y2e - r0, W, C,
            [&](int m, int c, float v0, float v1) {
              const int i = m / W, col = m - (m / W) * W;
              const size_t off = ((size_t)(r0 + i) * W + col) * C + o_base + c;
              const float2 res = __ldg(reinterpret_cast<const float2*>(xn + off));
              const float2 sc = __ldg(reinterpret_cast<const float2*>(s2 + c));
              const float2 sh = __ldg(reinterpret_cast<const float2*>(b2 + c));
              *reinterpret_cast<float2*>(on + off) = make_float2(
                  __fadd_rn(__fadd_rn(__fmul_rn(v0, sc.x), sh.x), res.x),
                  __fadd_rn(__fadd_rn(__fmul_rn(v1, sc.y), sh.y), res.y));
            });
  if (G > 1) cluster.sync();        // no CTA leaves while its u slice is read
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

// The f32 band height: 7 rows at C >= 256, where 4 or 5 make 32 or 24
// clusters at 14x14 and batch 8 and conv1's halo (R+2)/R costs most, 4
// below (more bands, enough CTAs at batch 8); lowered where the band does
// not fit in shared memory (images larger than IR-50's), and evened out
// over the bands (H / bands rounded up, as the kernel computes it).
// Returns R and its shared memory in bytes.
int f32_band_height(int H, int W, int C, size_t* smem) {
  int R = C >= 4 * TN ? 7 : 4;
  for (;;) {
    const int bands = (H + R - 1) / R;
    R = (H + bands - 1) / bands;
    *smem = f32_band_bytes(R, H, W, C) + f32_uslice_bytes(R, H, W, C) +
            f32_ring_bytes(R, W);
    if (*smem <= 232448 || R == 1) return R;      // 227 KB a CTA
    --R;
  }
}

int launch_f32(cudaStream_t s, const void* x, const void* w1, const void* w2,
               const float* par, void* out, int N, int H, int W, int C) {
  size_t smem;
  const int R = f32_band_height(H, W, C, &smem);
  return launch_clusters<float>(ir_block_f32_kernel, smem, s, x, w1, w2, par, out, N,
                                H, W, C, R);
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
  return launch_f32(s, x, w1, w2, p, out, N, H, W, C);
}
