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
//    of the cluster owns output channels 64g .. 64g+63 of both convs. Each
//    CTA holds t for the rows its conv1 reads, all C channels, in shared
//    memory (zero rows outside the image, zero columns either side), and
//    computes its 64 channels of u on the rows conv2 needs into its own
//    shared memory (rounded to the dtype, zero rows outside the image).
//    conv1 on the halo rows is computed by both neighbouring bands:
//    (R+2)/R of conv1's work. After a cluster barrier all C channels of u
//    are gathered from the cluster's CTAs, then conv2.
//  * Each conv is an implicit GEMM from shared memory: the band's pixels x
//    the CTA's 64 output channels, K = 9*C in the weight's (kh, kw, c)
//    order, so a K stage is channels of one tap.
//
// bf16 (ir_block_bf16_kernel): warpgroup tensor cores, wgmma.mma_async
// m64n64k16 bf16 -> f32 with both operands in shared memory, fed by a TMA
// weight ring (bf16 products are exact in f32, as in the plain version;
// only the order of the sums differs). What held back the mma.sync kernel
// it replaced, and what this one does about it:
//  * A __syncthreads and a cp.async round trip per 8 KB weight stage, with
//    2-3 m16 tiles a warp behind each. Here a producer warp keeps a ring of
//    NST = 4 stages (64 output channels x 64 of K, 8 KB) full by TMA,
//    through a 2-D tensor map over the (C, 9*C) weights with the 128-byte
//    swizzle the B descriptor reads, on a full and an empty mbarrier a slot.
//    The two consumer warpgroups wait on a stage's full barrier, issue its
//    wgmma, and free its slot with one arrive a warp once wgmma.wait_group
//    has seen the stage before read (LAG = 1). No barrier of the CTA is
//    left in a conv. (A ring of 8 and 3 or 5 stages of wgmma in flight
//    measured no faster.)
//  * Small tiles. A warpgroup's wgmma covers 64 positions x 64 channels x
//    k16. It holds 3 such accumulators (168 registers a thread: the
//    producer warp makes 9 warps, 3 on one of the SM's register files), as
//    up to 3 tiles or one tile's K in 3 chains (conv_pass): one chain
//    waits on each wgmma's latency, and the tensor cores round toward zero
//    as they accumulate (a chain of all 144 k16 steps at 14x14x256 left
//    outputs two bf16 steps off). A pass takes at most 6 tiles of 64
//    positions, 2 from C = 256 on (pass_tiles: 96 steps an accumulator at
//    most).
//  * The 3x3 gather. The band is stored chunk by chunk (8 channels = 16
//    bytes a pixel, a chunk's pixels contiguous, rows of W+2 pixels with the
//    zero columns in them), and each conv is computed at every position q =
//    row*(W+2) + column, the two columns past W included and discarded.
//    Then tap (kh, kw) of position q is pixel q + kh*(W+2) + kw: a tap is
//    an offset of the A descriptor's start address (no swizzle, K-major:
//    8-pixel core matrices of 128 contiguous bytes, the two 8-channel
//    halves of a k16 step one chunk apart). A comes straight from shared
//    memory, no ldmatrix, no registers held for it.
//  * The band height was fixed at 4. R is picked per launch (bf16_plan):
//    conv2 in one pass, the CTA within 227 KB, and the fewest rounds of
//    CTAs times a CTA's stages, a stage costed at no less than two tiles.
//    Where an image's band is one tile in both convs (7x7) and the batch
//    is even, a CTA takes two images, one tile a warpgroup, so that a
//    weight stage serves both.
//  * t and u between the cluster's CTAs: each CTA builds t for its own 64
//    channels only and sends them, as u later, into every other band of the
//    cluster with one bulk copy (cp.async.bulk shared::cluster) that
//    completes on the receiver's mbarrier: G times less of x read from L2
//    for t, and no 16-byte copies by every thread.
//  * Scattered stores. conv2's epilogue stages each warp's 16 rows in
//    shared memory: x comes in in 16-byte loads, the sums are added in
//    place, and the output goes out in 16-byte stores, 128 contiguous bytes
//    a pixel.
//  * The tensor maps are encoded once per weight tensor (the driver's
//    cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint: no link
//    flag) and kept, with the plans, in a host cache by pointer and shape.
// Not done: TMA multicast of a weight stage to two images' CTAs (built:
// every stage then waits for both CTAs' consumers, and it measured slower);
// the products of a CTA do not overlap its t build; a stage of one or two
// tiles takes several times its tensor-core time (PERF.md, section 6).
//
// f32 (ir_block_f32_kernel): warp-level tensor cores as 3xTF32, mma.sync
// m16n8k8 tf32 -> f32 (the f32 gallery search runs the same 3xTF32 on
// wgmma, topk_wgmma.cuh). One TF32 product keeps 11 bits of each
// operand, which would miss the plain version's f32 convs by about
// 1e-3; so each operand splits into hi + lo and lo*hi + hi*lo + hi*hi go
// into the accumulator, small terms first, about 21 bits of each product.
//  * The band's pixels are split into m16 tiles. The 8 warps are WM (pixels)
//    x 2 (32 channels each) x WK = 4/WM (split-K over the k8 steps of a
//    stage), WM chosen per conv so that a warp holds 2-3 tiles (MT at
//    most), and the WK groups' sums meet in shared memory at the end.
//  * A comes from the band with ldmatrix.x4: each lane passes the address of
//    its own pixel row shifted by the tap, so the implicit-GEMM gather of a
//    3x3 tap costs nothing. An 8x8 b16 ldmatrix tile of K-contiguous f32 is
//    the 8x4 tf32 fragment m16n8k8 takes, so A (band pixels, C+4 floats
//    apart) and B (weight rows) load with the same addresses. A stage is
//    64 channels of one tap, eight k8 steps, 24 mma per (m16, n8) tile, by
//    cp.async into a ring of two (a third bought nothing), one __syncthreads
//    a stage, whose 256-byte rows are unpadded, each 16-byte chunk c of row
//    n at c ^ (n % 8), so that 8 row addresses still fall in distinct bank
//    groups; t, u and the weights are split in registers after each
//    ldmatrix (split_tf32_trunc: hi = the top 19 bits, lo = x - hi, one
//    integer and one FP32 operation; Veltkamp's split_tf32, four FP32 ones,
//    was slower here). Weights split once on the host instead doubled the
//    weight stream and were slower at every shape (PERF.md, PR 19).
//  * The tensor cores round toward zero as they accumulate: a chain of
//    3*9*C/8 mma (1,728 at C = 512) drifts by ulps of the sum each step,
//    past 1e-4 of the output. Each stage sums into a fresh accumulator,
//    then added to the pixel's, rounded to nearest.
//  * Only rows in the image are computed: conv1 skips u's row above the
//    first band and those below the image in the last, conv2 output rows
//    past H; those u rows are zeroed instead. t is built with cp.async
//    (all of x's rows in flight), then the BN affine in place.
//  * One CTA per SM at every shape (two would need 113 KB each, below the t
//    band alone at 14x14x256 and 7x7x512: 163 KB). At C = 64 (G = 1) conv1
//    writes u straight into the band, u row y over t row y-2, which no later
//    pass of conv1 reads (every pass ends with a __syncthreads); the band
//    has R+5 rows. With G > 1 the band holds only the rows conv1 reads, each
//    CTA's u goes to its u slice (no zero columns) and is gathered into the
//    band. The split-K partial sums use the weight ring (at most 2 groups
//    along K, so that they fit). R is 7 at 14x14x256 and 7x7x512 (two bands
//    an image and one: conv1's halo 9/7, and half the clusters of R = 4,
//    each with twice the pixels, so a stage's fixed cost is shared by twice
//    the mma) and 4 at 56x56x64 and 28x28x128; lower where a band would not
//    fit (f32_band_height). Shared memory per CTA: 56x56x64 171 KB,
//    28x28x128 198 KB, 14x14x256 226 KB, 7x7x512 211 KB.
//  Left for later: wgmma and TMA for this path too (wgmma takes tf32 at the
//  full tensor-core rate, which mma.sync does not reach).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>
#include <utility>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TN = 64;   // output channels per CTA

// ---- bf16: wgmma fed by a TMA weight ring ------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int CONSUMER_WARPS = 8;                     // two warpgroups
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
// and the producer warp: 9 warps put 3 on one of an SM's 4 register files,
// so a thread has at most 168 registers, which holds ACC_SETS = 3 sets of
// 32 accumulators (4 would spill)
constexpr int BF16_THREADS = CONSUMERS + 32;
constexpr int NST = 4;                                // weight stages in the ring
constexpr int LAG = 1;          // stages whose wgmma may still run: NST - LAG load ahead
constexpr uint32_t STAGE_BYTES = TN * 64 * 2;         // 64 channels x 64 of K
constexpr int ACC_SETS = 3;                           // 64x64 f32 sums a warpgroup holds
constexpr int PASS_TILES = 2 * ACC_SETS;              // m64 tiles of a pass, at most
constexpr int MAX_CHAIN = 96;                         // k16 steps into one accumulator
constexpr int STG_ROW = TN * 2 + 16;                  // bytes of a staged output row
constexpr int STG_WARP = 16 * STG_ROW;                // a warp's staged rows
constexpr int MAX_BAND_ROWS = 16;
constexpr size_t MAX_SMEM = 232448;                   // 227 KB a CTA

// Image rows of the band from r0: conv1 computes u on rows y1 .. y1e-1 (the
// rows of r0-1 .. r0+R in the image), conv2 the output on r0 .. y2e-1.
__host__ __device__ __forceinline__ void band_rows(int r0, int R, int H, int& y1,
                                                   int& y1e, int& y2e) {
  y1 = r0 - 1 > 0 ? r0 - 1 : 0;
  y1e = r0 + R + 1 < H ? r0 + R + 1 : H;
  y2e = r0 + R < H ? r0 + R : H;
}

// m64 tiles of a conv over `rows` rows of W+2 positions
__host__ __device__ __forceinline__ int conv_tiles(int rows, int W) {
  return (rows * (W + 2) + 63) / 64;
}

// The most m64 tiles a pass of a conv over C channels takes: its warpgroups
// split them, and a warpgroup with NT tiles sums each into ACC_SETS / NT
// accumulators in turn (conv_pass), so that no accumulator takes more than
// MAX_CHAIN of the conv's 9*C/16 k16 steps: the tensor cores round toward
// zero as they accumulate, and one chain of all 144 steps at C = 256 left a
// few outputs two bf16 steps from the plain version's. C <= 128: 6 tiles;
// C = 256 and 512: 2 (one a warpgroup, in 3 accumulators).
__host__ __device__ __forceinline__ int pass_tiles(int C) {
  const int steps = 9 * C / 16;
  int t = PASS_TILES;
  while (t > 1) {
    const int nt = (t + 1) / 2, ks = ACC_SETS / nt;
    if ((steps + ks - 1) / ks <= MAX_CHAIN) break;
    --t;
  }
  return t;
}

// The bf16 kernel's layout at band height R, I images a CTA. A chunk is 8
// channels; the band (t, then u with all C channels) and the CTA's u slice
// (its 64 channels) hold each chunk's pixels of each image 16 bytes apart,
// rows of W+2 pixels with zero columns at 0 and W+1, slab (chunk c, image
// i) at c*I + i; np pixels a slab in both, odd, so that 16-byte stores to
// 8 chunks of one pixel fall in distinct bank groups, and the same, so that
// a CTA's 8*I slabs (its 64 channels) go from its u slice or its band to
// another's band in one bulk copy.
// Shared memory: the ring at 0 (1024-aligned, as the 128-byte swizzle
// wants), its 2 x NST mbarriers and the two of the t and u gathers, the
// band, the u slice.
struct Bf16Plan {
  int R;           // output rows a band
  int I;           // images a CTA: 2 where an image's band is one m64 tile
  int np;          // pixels a slab of the band and of the u slice
  int band_off, usl_off, smem;    // bytes
  int tiles1, tiles2;             // the most m64 tiles of a band's conv1, conv2
};

__host__ __device__ __forceinline__ Bf16Plan bf16_layout(int R, int I, int H, int W,
                                                         int C) {
  Bf16Plan p;
  p.R = R;
  p.I = I;
  const int W2 = W + 2;
  int rows1 = 0, rows2 = 0;
  for (int r0 = 0; r0 < H; r0 += R) {
    int y1, y1e, y2e;
    band_rows(r0, R, H, y1, y1e, y2e);
    rows1 = y1e - y1 > rows1 ? y1e - y1 : rows1;
    rows2 = y2e - r0 > rows2 ? y2e - r0 : rows2;
  }
  p.tiles1 = conv_tiles(rows1, W);
  p.tiles2 = conv_tiles(rows2, W);
  p.np = ((rows1 + 2) * W2) | 1;
  // the farthest pixel a conv's A reads past a chunk's start: its last
  // tile's last row shifted by the tap (2, 2)
  const int reach1 = p.tiles1 * 64 + 2 * W2 + 2;
  const int reach2 = p.tiles2 * 64 + 2 * W2 + 2;
  int last = p.np > reach1 ? p.np : reach1;
  if (C > TN && reach2 > last) last = reach2;            // conv2 reads the band
  size_t band = (size_t)16 * ((C / 8 * I - 1) * p.np + last);
  if (band < (size_t)CONSUMER_WARPS * STG_WARP) band = (size_t)CONSUMER_WARPS * STG_WARP;
  const size_t usl = (size_t)16 * ((8 * I - 1) * p.np + (p.np > reach2 ? p.np : reach2));
  p.band_off = (int)(NST * STAGE_BYTES + 128);
  p.usl_off = p.band_off + (int)((band + 127) / 128 * 128);
  p.smem = p.usl_off + (int)((usl + 127) / 128 * 128);
  return p;
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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// The weight ring: NST slots of one stage each, a full and an empty
// mbarrier a slot. A CTA's stages, in the order the convs take them, are
// w1's S stages once per pass of conv1, then w2's; stage g goes to slot
// g % NST. One lane of the producer warp keeps NST of them in flight: it
// loads the first NST, and once every consumer warp has freed stage g's
// slot (its empty barrier completes phase g / NST), it loads stage g + NST
// there. The consumers wait on a slot's full barrier, which completes when
// its TMA bytes land. (A consumer warp that loads stalls its own wgmma and
// leaves its warpgroup diverged between them, which ptxas serializes.)
struct WeightRing {
  uint32_t ring, full, empty;     // shared addresses
  const CUtensorMap* map1;
  const CUtensorMap* map2;
  int split, total;               // w1's stages, all stages
  int S, o_base;

  __device__ __forceinline__ void load(int g) const {
    const int slot = g % NST;
    const bool w1 = g < split;
    mbar_expect_tx(full + 8 * slot, STAGE_BYTES);
    tma_load_2d(ring + (uint32_t)slot * STAGE_BYTES, w1 ? map1 : map2,
                (w1 ? g % S : g - split) * 64, o_base, full + 8 * slot);
  }
  // stages from .. to-1, each once its slot is free
  __device__ __forceinline__ void produce(int from, int to) const {
    for (int g = from; g < to; ++g) {
      if (g >= NST) mbar_wait(empty + 8 * (g % NST), (uint32_t)(g / NST - 1) & 1);
      load(g);
    }
  }
};

// One pass of a conv for this warpgroup: NT m64 tiles (rows q0 + 64i of the
// conv's positions, q = row * (W+2) + column, A row q of tap (kh, kw) at
// pixel q + kh*(W+2) + kw of the chunks) x the CTA's 64 output channels,
// K = 9*C in S stages of 64 (one tap, 8 chunks). `a0` is the shared
// address of tile 0's first row in chunk 0, np16 the bytes a chunk. Stage
// `it` of the ring is in slot it % NST; its full barrier completes phase
// it / NST; every consumer warp arrives on its empty barrier once its
// wgmma have read it. A warpgroup with no tile (NT = 0) still takes its
// turn at every barrier.
// The warpgroup's ACC_SETS accumulators are split over its tiles, KS =
// ACC_SETS / NT a tile, and k16 step 4s + kk of the pass goes into set
// (4s + kk) % KS: KS independent chains of wgmma a tile, each 1/KS of K
// (a chain waits on each wgmma's latency; and see pass_tiles), added
// rounded to nearest at the end. Leaves tile i's sums in acc[i].
template <int NT>
__device__ __forceinline__ void conv_pass(float (&acc)[ACC_SETS][32], uint32_t a0,
                                          uint32_t np16, int S, int CS, int W2,
                                          const WeightRing& wr, int& it) {
  constexpr int KS = NT > 0 ? ACC_SETS / NT : 1;
  constexpr int U = KS == 3 ? 3 : 1;              // stages a turn of the sets takes
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NT * KS; ++i) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;
    fence_acc(acc[i]);
  }
  for (int s0 = 0; s0 < S; s0 += U) {              // S = 9 * C/64 is a multiple of U
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u, slot = it % NST;
      static_assert(LAG < NST, "a stage's slot is freed LAG stages later");
      const int tap = s / CS;
      const int kh = tap / 3, kw = tap - kh * 3;
      const uint32_t a_st =
          a0 + (uint32_t)((s - tap * CS) * 8) * np16 + (uint32_t)((kh * W2 + kw) * 16);
      const uint32_t b_st = wr.ring + (uint32_t)slot * STAGE_BYTES;
      mbar_wait(wr.full + 8 * slot, (uint32_t)(it / NST) & 1);
      if (NT > 0) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = smem_desc(b_st + kk * 32, 16, 1024, 1);
#pragma unroll
          for (int i = 0; i < NT; ++i)
            wgmma_m64n64k16(acc[i * KS + (4 * u + kk) % KS],
                            smem_desc(a_st + 2 * kk * np16 + i * 1024, np16, 128, 0), db);
        }
        wgmma_commit();
        wgmma_wait<LAG>();                   // stage s - LAG is read
      }
      if (s >= LAG && lane == 0) mbar_arrive(wr.empty + 8 * ((it - LAG) % NST));
      ++it;
    }
  }
  if (NT > 0) wgmma_wait<0>();
  if (lane == 0)
    for (int k = S < LAG ? S : LAG; k > 0; --k) mbar_arrive(wr.empty + 8 * ((it - k) % NST));
#pragma unroll
  for (int i = 0; i < NT * KS; ++i) fence_acc(acc[i]);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float v = acc[i * KS][j];
#pragma unroll
      for (int k = 1; k < KS; ++k) v = __fadd_rn(v, acc[i * KS + k][j]);
      acc[i][j] = v;
    }
  }
}

// A pass of `tn` tiles from tile `first` of a conv (a0: the shared address
// of tile 0's first row, `tile` bytes from one tile to the next; np16: the
// bytes from one chunk to the next): the first warpgroup takes ceil(tn/2)
// of them, the second the rest. Returns the tiles this warpgroup holds in
// acc[0 ..] for the epilogue and sets `mine0` to the first of them.
__device__ __forceinline__ int conv_pass_n(int tn, int first, float (&acc)[ACC_SETS][32],
                                           uint32_t a0, uint32_t tile, uint32_t np16,
                                           int S, int CS, int W2, const WeightRing& wr,
                                           int& it, int& mine0) {
  static_assert(ACC_SETS == 3, "conv_pass_n dispatches 0 to 3 tiles");
  const int wg = threadIdx.x >> 7, half = (tn + 1) / 2;
  const int nt = wg == 0 ? half : tn - half;
  mine0 = first + (wg == 0 ? 0 : half);
  const uint32_t a = a0 + (uint32_t)mine0 * tile;
  switch (nt) {
    case 3: conv_pass<3>(acc, a, np16, S, CS, W2, wr, it); break;
    case 2: conv_pass<2>(acc, a, np16, S, CS, W2, wr, it); break;
    case 1: conv_pass<1>(acc, a, np16, S, CS, W2, wr, it); break;
    default: conv_pass<0>(acc, a, np16, S, CS, W2, wr, it);
  }
  return nt;
}

// Grid (bands * G, N), clusters of G = C/64 CTAs along x, BF16_THREADS
// threads: warps 0-7 two consumer warpgroups, warp 8 the producer. CTA g of
// a cluster owns output channels 64g .. 64g+63 of both convs.
__global__ void __launch_bounds__(BF16_THREADS, 1)
ir_block_bf16_kernel(const __grid_constant__ CUtensorMap map1,
                     const __grid_constant__ CUtensorMap map2, const bf16* __restrict__ x,
                     const float* __restrict__ par, bf16* __restrict__ out, int H, int W,
                     int C, const Bf16Plan plan) {
  // (named apart from the f32 kernel's 16-aligned `smem`: one extern
  // array of both names would take one alignment)
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  unsigned char* smem = smem_bf16;
  cg::cluster_group cluster = cg::this_cluster();
  const int g = (int)cluster.block_rank();
  const int G = (int)cluster.num_blocks();
  const int R = plan.R, I = plan.I, W2 = W + 2;
  const int CS = C / 64, S = 9 * CS;                  // stages a pass
  const int n0 = blockIdx.y * I;                      // the CTA's first image
  const int r0 = (blockIdx.x / G) * R;
  int y1, y1e, y2e;
  band_rows(r0, R, H, y1, y1e, y2e);
  const int rows1 = y1e - y1, rows2 = y2e - r0;
  const int tiles1 = conv_tiles(rows1, W), tiles2 = conv_tiles(rows2, W);
  const int passes1 = (tiles1 + pass_tiles(C) - 1) / pass_tiles(C);
  const int o_base = g * TN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + NST * STAGE_BYTES;     // NST barriers each
  const uint32_t empty = full + 8 * NST;
  const uint32_t u_in = empty + 8 * NST;              // u gathered into the band
  const uint32_t t_in = u_in + 8;                     // t gathered into the band
  unsigned char* band = smem + plan.band_off;
  unsigned char* uslice = smem + plan.usl_off;

  const WeightRing wr = {ring, full, empty, &map1, &map2, passes1 * S,
                         (passes1 + 1) * S, S, o_base};
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMER_WARPS);
    }
    mbar_init(u_in, 1);
    mbar_init(t_in, 1);
    // the other CTAs' t chunks (8*I slabs each)
    if (G > 1) mbar_expect_tx(t_in, (uint32_t)((G - 1) * 8 * I * plan.np * 16));
    mbar_fence_init();
  }
  __syncthreads();
  // every CTA's barriers are set up before another's bulk copies reach them
  cluster_arrive();

  if (warp == CONSUMER_WARPS) {
    // the producer: w1's stages and w2's first NST before the consumers'
    // first cluster barrier (conv1 frees their slots), the rest after it;
    // then the cluster barrier the consumers end on
    const int pre = wr.split + NST < wr.total ? wr.split + NST : wr.total;
    cluster_wait();
    if (lane == 0) wr.produce(0, pre);
    __syncwarp();
    cluster.sync();
    if (lane == 0) wr.produce(pre, wr.total);
    __syncwarp();
    cluster_arrive();
    cluster_wait();
    return;
  }
  const int wg = warp >> 2, wi = warp & 3;            // warpgroup, warp in it
  const size_t image = (size_t)H * W * C;
  const float* s1 = par;
  const float* b1 = par + C;
  const float* alpha = par + 2 * C + o_base;
  const float* s2 = par + 3 * C + o_base;
  const float* b2 = par + 4 * C + o_base;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // t = bf16(f32(x)*s1 + b1) on image rows y1-1 .. y1e (band rows 0 ..
  // rows1+1) of each of the CTA's images, 0 off the image and in columns 0
  // and W+1: this CTA builds its own 64 channels (8 chunks; 16 bytes an
  // element, eight loads in flight a thread) and sends them to the
  // cluster's other bands, which send theirs
  const int tb = y1 - 1;
  const int nt = (rows1 + 2) * W2 * 8;                 // elements an image
  for (int e0 = threadIdx.x; e0 < I * nt; e0 += 8 * CONSUMERS) {
    uint4 q[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * CONSUMERS, ii = e >= nt, r = e - ii * nt;
      const int c8 = 8 * g + r % 8, pix = r / 8, i = pix / W2, col = pix - i * W2 - 1;
      const int gy = tb + i;
      q[k] = zero;
      if (e < I * nt && gy >= 0 && gy < H && col >= 0 && col < W)
        q[k] = __ldg(reinterpret_cast<const uint4*>(x + (n0 + ii) * image +
                                                    ((size_t)gy * W + col) * C + c8 * 8));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * CONSUMERS, ii = e >= nt, r = e - ii * nt;
      if (e >= I * nt) break;
      const int c8 = 8 * g + r % 8, pix = r / 8, i = pix / W2, col = pix - i * W2 - 1;
      const int gy = tb + i;
      uint4 v = zero;
      if (gy >= 0 && gy < H && col >= 0 && col < W) {
        const uint32_t xw[4] = {q[k].x, q[k].y, q[k].z, q[k].w};
        uint32_t tw[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int c = c8 * 8 + 2 * h;
          const float2 xf = unpack_bf16x2(xw[h]);
          const float2 sc = __ldg(reinterpret_cast<const float2*>(s1 + c));
          const float2 sh = __ldg(reinterpret_cast<const float2*>(b1 + c));
          tw[h] = pack_bf16x2(__fadd_rn(__fmul_rn(xf.x, sc.x), sh.x),
                              __fadd_rn(__fmul_rn(xf.y, sc.y), sh.y));
        }
        v = make_uint4(tw[0], tw[1], tw[2], tw[3]);
      }
      *reinterpret_cast<uint4*>(band + ((size_t)(c8 * I + ii) * plan.np + pix) * 16) = v;
    }
  }
  // the u slice's pixels that conv1 does not write: columns 0 and W+1, and
  // the rows off the image (u rows r0-1 .. y2e, u slice rows 0 .. rows2+1)
  const int nu = (rows2 + 2) * W2;
  for (int e = threadIdx.x; e < 8 * I * nu; e += CONSUMERS) {
    const int slab = e / nu, pix = e - slab * nu;
    const int i = pix / W2, col = pix - i * W2, gy = r0 - 1 + i;
    if (col == 0 || col == W + 1 || gy < 0 || gy >= H)
      *reinterpret_cast<uint4*>(uslice + ((size_t)slab * plan.np + pix) * 16) = zero;
  }
  const uint32_t np16 = (uint32_t)plan.np * 16;
  const uint32_t band_s = smem_u32(band), usl_s = smem_u32(uslice);
  // a CTA's 8*I slabs from slab 8*g*I, one bulk copy to each other band
  const uint32_t own = (uint32_t)(8 * I) * np16, own_at = (uint32_t)g * own;
  fence_proxy_async();
  consumers_sync();
  cluster_wait();
  if (G > 1) {
    if (warp == 0 && lane < G && lane != g)
      bulk_copy_to_cluster(cluster_addr(band_s + own_at, (uint32_t)lane), band_s + own_at,
                           own, cluster_addr(t_in, (uint32_t)lane));
    mbar_wait(t_in, 0);
  }

  // conv1: u on image rows y1 .. y1e-1, this CTA's channels, prelu and
  // rounded, into the u slice; passes of at most pass_tiles(C) tiles, each
  // warpgroup half of them. With two images (one tile each) the tiles of a
  // pass are the images' and each warpgroup takes one.
  float acc[ACC_SETS][32];
  int it = 0;
  const int per1 = (tiles1 + passes1 - 1) / passes1;
  for (int p = 0; p < passes1; ++p) {
    const int t0 = p * per1, tn = min(per1, tiles1 - t0);
    int first;
    const int mine = conv_pass_n(I * tn, t0, acc, band_s, I == 2 ? np16 : 1024,
                                 I * np16, S, CS, W2, wr, it, first);
    // lane l holds rows 16*wi + l/4 (+8) of each tile, channels 8j + 2(l%4)
#pragma unroll
    for (int i = 0; i < ACC_SETS; ++i) {
      if (i >= mine) break;
      const int ii = I == 2 ? first + i : 0, t = I == 2 ? 0 : first + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = t * 64 + wi * 16 + (lane >> 2) + 8 * h;
        const int j = q / W2, col = q - j * W2;
        if (q >= rows1 * W2 || col >= W) continue;
        unsigned char* dst = uslice + ((size_t)ii * plan.np +
                                       (size_t)(y1 + j - r0 + 1) * W2 + col + 1) * 16 +
                             (lane & 3) * 4;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 a = __ldg(reinterpret_cast<const float2*>(alpha + 8 * jj +
                                                                 2 * (lane & 3)));
          const float v0 = acc[i][4 * jj + 2 * h], v1 = acc[i][4 * jj + 2 * h + 1];
          *reinterpret_cast<uint32_t*>(dst + (size_t)jj * I * np16) =
              pack_bf16x2(v0 > 0.f ? v0 : __fmul_rn(v0, a.x),
                          v1 > 0.f ? v1 : __fmul_rn(v1, a.y));
        }
      }
    }
  }
  // the band takes all C channels of u (the R+2 rows conv2 reads, zero
  // columns included): each CTA sends its u slice (its 8*I slabs) into the
  // band of every CTA of the cluster, one bulk copy each, which completes on
  // the receiver's u_in barrier. With G = 1 conv2 reads the u slice itself.
  if (G > 1 && threadIdx.x == 0) mbar_expect_tx(u_in, (uint32_t)G * own);
  fence_proxy_async();
  cluster.sync();                   // every u slice is written; the bands are free
  if (G > 1) {
    if (warp == 0 && lane < G)
      bulk_copy_to_cluster(cluster_addr(band_s + own_at, (uint32_t)lane), usl_s, own,
                           cluster_addr(u_in, (uint32_t)lane));
    mbar_wait(u_in, 0);
  }
  // no CTA leaves before every copy out of its u slice has landed: each
  // arrives once its own band is whole and waits for the others at its end
  cluster_arrive();

  // conv2: the output on image rows r0 .. y2e-1, this CTA's channels, one
  // pass
  int first2;
  const uint32_t a2 = G > 1 ? band_s : usl_s, np2 = G > 1 ? np16 : np16;
  const int mine2 = conv_pass_n(I * tiles2, 0, acc, a2, I == 2 ? np2 : 1024, I * np2, S,
                                CS, W2, wr, it, first2);
  consumers_sync();                 // no wgmma reads the band any more

  // out = bf16(m2*s2 + b2 + f32(x)) through this warp's 16 staged rows in
  // the band: x in, the sums added in place, out in 16-byte runs
  unsigned char* stg = band + warp * STG_WARP;
#pragma unroll
  for (int i = 0; i < ACC_SETS; ++i) {
    if (i >= mine2) break;
    const int ii = I == 2 ? first2 + i : 0, t = I == 2 ? 0 : first2 + i;
    const bf16* xn = x + (n0 + ii) * image;
    bf16* on = out + (n0 + ii) * image;
    const int q0 = t * 64 + wi * 16;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = (lane >> 3) + 4 * k, q = q0 + r, j = q / W2, col = q - j * W2;
      if (q < rows2 * W2 && col < W)
        *reinterpret_cast<uint4*>(stg + r * STG_ROW + (lane & 7) * 16) =
            __ldg(reinterpret_cast<const uint4*>(xn + ((size_t)(r0 + j) * W + col) * C +
                                                 o_base + (lane & 7) * 8));
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (lane >> 2) + 8 * h, q = q0 + r, j = q / W2, col = q - j * W2;
      if (q >= rows2 * W2 || col >= W) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 8 * jj + 2 * (lane & 3);
        uint32_t* p = reinterpret_cast<uint32_t*>(stg + r * STG_ROW + c * 2);
        const float2 res = unpack_bf16x2(*p);
        const float2 s = __ldg(reinterpret_cast<const float2*>(s2 + c));
        const float2 b = __ldg(reinterpret_cast<const float2*>(b2 + c));
        const float v0 = acc[i][4 * jj + 2 * h], v1 = acc[i][4 * jj + 2 * h + 1];
        *p = pack_bf16x2(__fadd_rn(__fadd_rn(__fmul_rn(v0, s.x), b.x), res.x),
                         __fadd_rn(__fadd_rn(__fmul_rn(v1, s.y), b.y), res.y));
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = (lane >> 3) + 4 * k, q = q0 + r, j = q / W2, col = q - j * W2;
      if (q < rows2 * W2 && col < W)
        *reinterpret_cast<uint4*>(on + ((size_t)(r0 + j) * W + col) * C + o_base +
                                  (lane & 7) * 8) =
            *reinterpret_cast<const uint4*>(stg + r * STG_ROW + (lane & 7) * 16);
    }
    __syncwarp();
  }
  cluster_wait();
}

// ---- f32: 3xTF32 on warp-level tensor cores --------------------------------

constexpr int MT = 3;             // m16 tiles a warp holds at once (x 4 n8 tiles)

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

// The bf16 band height R and images a CTA I for N images of H x W x C on
// `sms` SMs: conv2 takes one pass (R * (W+2) <= pass_tiles(C) * 64
// positions), the CTA fits in shared memory, and, of those, the least
// cost: rounds of CTAs over the SMs times a CTA's stages, each costed at
// its pass's m64 tiles but at least 2 (a stage's 8 KB of weights from L2
// take about as long as two tiles' products). I = 2 takes two images'
// bands where each is one tile in both convs (7x7): one tile a warpgroup,
// a weight stage for both, half the CTAs. Ties go to the higher band (fewer
// CTAs, less weight traffic), then to one image a CTA (more SMs at work).
// Returns 0, or
// cudaErrorInvalidConfiguration where nothing fits.
int bf16_plan(int N, int H, int W, int C, int sms, Bf16Plan* out) {
  long best = -1;
  const int S = 9 * C / 64;
  const int pt = pass_tiles(C);
  for (int R = 1; R <= H && R <= MAX_BAND_ROWS && R * (W + 2) <= pt * 64; ++R)
  for (int I = 2; I >= 1; --I) {
    const Bf16Plan p = bf16_layout(R, I, H, W, C);
    if ((size_t)p.smem > MAX_SMEM ||
        (I == 2 && (N % 2 || p.tiles1 > 1 || p.tiles2 > 1 || pt < 2)))
      continue;
    const int passes = (p.tiles1 + pt - 1) / pt;
    const int per = (p.tiles1 + passes - 1) / passes;
    long stages = 0;
    for (int t = p.tiles1; t > 0; t -= per) {
      const int k = t < per ? t : per;
      stages += k > 2 ? k : 2;
    }
    stages += p.tiles2 > 2 ? p.tiles2 : 2;
    const long ctas = (long)((H + R - 1) / R) * (C / TN) * (N / I);
    const long cost = (ctas + sms - 1) / sms * stages * S;
    if (best < 0 || cost <= best) {
      best = cost;
      *out = p;
    }
  }
  return best < 0 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

// SMs of the current device, looked up once per device
int sm_count(int* sms) {
  static int cache[64] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && cache[dev] > 0) {
    *sms = cache[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) cache[dev] = *sms;
  return 0;
}

// The plans and the weights' tensor maps, kept across calls: the served
// paths run the same shapes and the same weights again and again, and a
// map encodes only the pointer, the shape and the strides, so a hit on
// (pointer, C) is the map itself, whatever the tensor now holds. Each is
// cleared when it grows past 4096 entries.
std::mutex cache_mutex;
std::map<std::array<int, 5>, Bf16Plan> plan_cache;
std::map<std::pair<uintptr_t, int>, CUtensorMap> map_cache;

int cached_plan(int N, int H, int W, int C, int sms, Bf16Plan* plan) {
  const std::array<int, 5> key = {N, H, W, C, sms};
  std::lock_guard<std::mutex> lock(cache_mutex);
  const auto hit = plan_cache.find(key);
  if (hit != plan_cache.end()) {
    *plan = hit->second;
    return 0;
  }
  const int err = bf16_plan(N, H, W, C, sms, plan);
  if (err) return err;
  if (plan_cache.size() >= 4096) plan_cache.clear();
  plan_cache.emplace(key, *plan);
  return 0;
}

// The map of weights w (C, 3, 3, C) bf16 as C rows of 9*C, in boxes of 64
// rows x 64 of K (128 bytes: the 128-byte swizzle)
int weight_map(const void* w, int C, CUtensorMap* map) {
  const std::pair<uintptr_t, int> key = {reinterpret_cast<uintptr_t>(w), C};
  std::lock_guard<std::mutex> lock(cache_mutex);
  const auto hit = map_cache.find(key);
  if (hit != map_cache.end()) {
    *map = hit->second;
    return 0;
  }
  const int err = encode_bf16_2d(map, w, (uint64_t)C, (uint64_t)9 * C, TN, 64);
  if (err) return err;
  if (map_cache.size() >= 4096) map_cache.clear();
  map_cache.emplace(key, *map);
  return 0;
}

int launch_bf16(cudaStream_t s, const void* x, const void* w1, const void* w2,
                const float* par, void* out, int N, int H, int W, int C) {
  int sms;
  int err = sm_count(&sms);
  if (err) return err;
  Bf16Plan plan;
  CUtensorMap m1, m2;
  if ((err = cached_plan(N, H, W, C, sms, &plan)) || (err = weight_map(w1, C, &m1)) ||
      (err = weight_map(w2, C, &m2)))
    return err;
  const int G = C / TN;
  cudaError_t e = cudaFuncSetAttribute(
      ir_block_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((H + plan.R - 1) / plan.R) * G, N / plan.I);
  cfg.blockDim = dim3(BF16_THREADS);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ir_block_bf16_kernel, m1, m2, static_cast<const bf16*>(x),
                         par, static_cast<bf16*>(out), H, W, C, plan);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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
// par (5, C) f32 = s1, b1, alpha, s2, b2, all contiguous and 16-byte aligned
// on one device; C a multiple of 64 up to 512; N*H*W*C below 2**31.
extern "C" int facekit_ir_block(const void* x, const void* w1, const void* w2,
                                const void* par, void* out, int N, int H, int W,
                                int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(par);
  if (dtype == 1) return launch_bf16(s, x, w1, w2, p, out, N, H, W, C);
  return launch_f32(s, x, w1, w2, p, out, N, H, W, C);
}

// The bf16 kernel's plan for N x H x W x C on `sms` SMs (bf16_plan), for
// the tests that hold ops/ir_block.py's mirror of it: out = band height,
// shared memory bytes, cluster size, conv1 and conv2 m64 tiles of the
// largest band, CTAs, images a CTA. Returns 0 or bf16_plan's error.
extern "C" int facekit_ir_block_bf16_plan(int N, int H, int W, int C, int sms, int* out) {
  Bf16Plan p;
  const int err = bf16_plan(N, H, W, C, sms, &p);
  if (err) return err;
  out[0] = p.R;
  out[1] = p.smem;
  out[2] = C / TN;
  out[3] = p.tiles1;
  out[4] = p.tiles2;
  out[5] = ((H + p.R - 1) / p.R) * (C / TN) * (N / p.I);
  out[6] = p.I;
  return 0;
}
