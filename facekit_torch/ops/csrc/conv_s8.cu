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
// C a power of two >= 16 or C <= 8 (the stems' 3 channels, read as they
// are), O a multiple of 8; or depthwise (groups = C = O, 3x3, C a multiple
// of 4). The result is the exact integer sum, as the TPU kernel's s32
// accumulation gives it.
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
// depthwise band kernel; else the plan names the route (bn = 0: the dense
// band kernel on __dp4a).
//
// C >= 16: an implicit GEMM on warpgroup tensor cores (conv_s8_wgmma_kernel
// <BN>). M = N*OH*OW output pixels, N_gemm = O, K = KS*KS*C in the weight's
// order (kh, kw, c), so a run of K is channels of one tap, contiguous in
// NHWC. What held back the mma.sync kernel it replaced (at 24x / 9x / 3.6x
// its bound per int8 IR-50 forward at batch 1 / 8 / 64), and what this one
// does about it:
//  * Every thread computed tap addresses and issued 2-4 cp.async gathers a
//    stage, then a __syncthreads, and each warp reloaded its operands into
//    registers with ldmatrix for every 32 bytes of K. Here one producer
//    warp keeps a ring of stages (128 pixels x 128 bytes of K, and BN
//    output channels x the same K) full by TMA, on a full and an empty
//    mbarrier a slot; the K loop has no barrier of the CTA. A stage of
//    pixels is one im2col load of x's tensor map (or 128 / C of them for C
//    < 128, one a tap), whose bounding box is the first taps of the output
//    pixels: lower corner -pad, upper corner pad - (KS - 1), traversed at
//    the conv's stride, the tap added as the load's offset. So the
//    hardware gathers the patch rows, taps off the image and pixels past
//    the last image arrive as zeros, and no address is computed a pixel.
//    The 1x1 stride-2 shortcuts are such a map too (corners 0). The
//    wrapper computes the box (`_im2col_box`) and passes it here. The
//    weights come through a tiled map of (O, K), 128 bytes of K a box,
//    zeros past O and past K.
//  * Two consumer warpgroups, 64 pixels each, issue wgmma.mma_async
//    m64nBNk32 s8 -> s32 with both operands read from shared memory
//    through descriptors (the loads' swizzle: 128 bytes for C >= 128, 64 or
//    32 at C = 64 or 32, none at C = 16, where a k32 step's two 16-byte
//    halves are two loads apart), four a stage, one stage of them left in
//    flight while the next stage's barrier is awaited. A stage's slot is
//    freed by one arrive a warp once its wgmma are done.
//  * A detector site with O = 8, 16 or 32 ran a 64-wide tile, mostly zero.
//    BN is O's own width where O <= 128 (8, 16, 24, 32, 48, 64, 96 or 128:
//    the s8 wgmma widths instantiated here, the least that holds O), else
//    O split as evenly into tiles of at most 128 (`_conv_plan`).
//  * The sums go out from registers: each thread stores two int32 of a
//    pixel at a time, four neighbouring lanes 32 contiguous bytes. Where
//    the tiles fill the card, a CTA is persistent (one an SM: 227 KB of
//    shared memory holds a ring of up to 8 stages) and walks tiles
//    blockIdx.x, += gridDim.x, the n tiles of a run of pixels next to each
//    other so that they read its patch rows from L2 together; the producer
//    runs on into the next tile's stages while the consumers store.
//  * Where O is one tile and its weights leave room for 4 stages of pixels
//    (every IR-50 site of O <= 128 but none of O >= 256), each CTA loads
//    them once, on a barrier of their own, and the ring carries pixels
//    alone: the large maps' CTAs read them from L2 again for every tile
//    otherwise (a third of the 112x112 site's L2 reads at batch 64).
//    What is left is the im2col itself: a 3x3 site reads each input row
//    through L2 once a tap, and at batch 64 the sites move 4-5 TB/s
//    between L2 and the SMs. (Tried and slower: multicasting the operand
//    two or four CTAs share, pixels or weights, over a cluster, whose
//    CTAs then wait for each other's consumers every stage; 256-wide
//    tiles, which spill at the 168 registers a thread of 288 gets; the
//    output stored evict-first.)
//  * Split K, where the tiles fill fewer CTAs than the card has SMs (small
//    batches, the 14x14 and 7x7 stages): blockIdx.y takes stages
//    stages*y/splits .. stages*(y+1)/splits - 1, and the splits of a tile
//    run as one thread-block cluster (2, 4 or 8 CTAs: a GPC's 16 SMs hold
//    whole clusters of them). Each CTA leaves its partial tile in its
//    shared memory (the ring, consumed); after a cluster barrier each sums
//    a share of the tile's rows over every CTA's tile through distributed
//    shared memory and writes them out in 16-byte runs. No atomics, no
//    zeroed output, no second launch; int32 sums are exact, so the result
//    is bit-equal to a single pass.
//  * The weights' map and x's map are kept in a host cache by pointer and
//    shape (a map encodes only those), so a served forward, whose buffers
//    recur, encodes a map only on a miss.
//
// The two CUDA-core routes (C <= 8, and depthwise) work in row bands. In
// NHWC, R whole output rows of one image are one contiguous run of out
// (R*OW*O*4 bytes), and their (R-1)*stride + KS input rows one run of x.
// A persistent CTA walks bands (blockIdx.x, += gridDim.x; blockIdx.y a
// tile of output channels). It keeps the input rows of the next RING - 1
// bands in flight into a ring of shared buffers with cp.async (zero-filled
// off the image, nothing read past x's end) while it sums the current
// band from shared memory. A band's sums are short: with one band of
// loads in flight, each band waited out the memory's latency. The sums go
// out from registers in 16-byte stores, neighbouring lanes on neighbouring
// 16 bytes, so that a warp writes 512 contiguous bytes of the band at
// once; where a CTA holds fewer channels than O, each pixel's run of them.
// (A form that staged each band in shared memory and sent it out as one
// bulk copy, cp.async.bulk, was slower at every site.) Both routes are
// bound by the bytes of their int32 output. The wrapper's `_band_plan`
// takes the fewest rows a band with which every band runs at once (two
// CTAs an SM), at most 8 (a larger map gives each CTA several bands); it
// splits the channels only where a row does not fit or (depthwise) the map
// has too few rows for the SMs.
//
// C <= 8 (the stems' 3 channels, 8-channel inputs): conv_s8_band_dp4a_kernel
// <KS, CW, OT>. K is KS*KS*CW words of 4 input channels (CW = 1 for C <= 4,
// else 2), fixed at compile time, with no zero words. The raw input rows
// are unpacked into a tile of such words (channels past C zero), so x is
// read as it is, with no padded copy. OT, the output channels of a tile,
// is O for O in {8, 16, 32, 64}, else 64 (the last tile partly past O).
// Each thread keeps the K weight words of 4 output channels in registers,
// loaded once a CTA, and sums pixel after pixel with __dp4a: one shared
// word a tap feeds 4 __dp4a. Tensor cores would buy nothing here. At the
// IR-50 stem (64 x 112x112x3 -> 64) the int32 output is 205 MB (0.062 ms
// at 3.35 TB/s), against 2.8 G int8 operations, about 0.02 ms on the CUDA
// cores' __dp4a.
//
// groups = C (the detectors' depthwise 3x3 sites): conv_s8_band_dw_kernel.
// No sum runs across channels, so there is no matrix product for the
// tensor cores. Threads spread over the channels and pixels of a band,
// and the channels over CTAs where the rows are few (the late 18x20 and
// 9x10 maps). Every tap is read from the shared tile, 4 channels a word.
// Bound by bytes: N*H*W*C in, 9*C weights, 4*N*OH*OW*C out.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int SMEM_MAX = 232448;    // the dynamic shared memory a CTA may take

// Sets a kernel's dynamic shared-memory limit to SMEM_MAX once per device.
template <typename Kernel>
int allow_smem(Kernel kernel, bool (&set)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) set[dev] = true;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// the tensor-core route (C >= 16)

constexpr int TC_BM = 128;                        // output pixels a tile
constexpr int TC_BK = 128;                        // bytes of K a stage
constexpr int TC_CONSUMER_WARPS = 8;              // two warpgroups, 64 pixels each
constexpr int TC_CONSUMERS = 32 * TC_CONSUMER_WARPS;
constexpr int TC_THREADS = TC_CONSUMERS + 32;     // and the producer warp
constexpr int TC_A_BYTES = TC_BM * TC_BK;         // a stage's pixels
constexpr int MAX_SPLITS = 8;                     // CTAs of a cluster (the portable most)
constexpr int TC_MIN_NST = 4;                     // stages of pixels beside resident weights

// A CTA's shared memory at tile width BN, 1024-aligned (the 128-byte
// swizzle's span of 8 rows): a ring of `nst` stages, each 128 pixels x 128
// bytes of K and, unless the weights are resident, BN output channels x
// the same K (128-byte rows); then, with resident weights, all the CTA's
// weight stages; then a full and an empty mbarrier a slot and the
// weights' barrier. A split's partial tile (CSTR words a pixel, padded so
// that the stores of 8 pixels spread over the banks) reuses the ring.
template <int BN>
struct TcConv {
  static constexpr int B_BYTES = BN * TC_BK;
  static constexpr int STAGE = TC_A_BYTES + B_BYTES;
  static constexpr int MAX_NST = 8;
  static constexpr int CSTR = BN + 8;
  // the ring of stages that fit beside `resident` bytes of weights
  __host__ __device__ static constexpr int nst(int resident) {
    return (SMEM_MAX - 2048 - resident) / (resident ? TC_A_BYTES : STAGE) < MAX_NST
               ? (SMEM_MAX - 2048 - resident) / (resident ? TC_A_BYTES : STAGE)
               : MAX_NST;
  }
  __host__ __device__ static constexpr int smem(int resident) {
    return 1024 + nst(resident) * (resident ? TC_A_BYTES : STAGE) + resident +
           16 * MAX_NST + 16;
  }
  static_assert(TC_BM * CSTR * 4 <= nst(0) * STAGE, "a partial tile fits in the ring");
  static_assert(smem(0) <= SMEM_MAX, "a CTA fits in shared memory");
};

// The launch's shape: the GEMM (M pixels, O channels, K = KS*KS*C bytes),
// the conv (output size, stride, padding, kernel size, log2 of C), the
// bytes of an im2col load (cb = min(C, TC_BK)), the stages of K, the tiles
// (n_tiles along O for each run of TC_BM pixels) and whether the weights
// are resident (their bytes, else 0).
struct TcArgs {
  int M, O, K, OH, OW, stride, pad, KS, lc, cb, stages, n_tiles, tiles, resident;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TC_CONSUMERS) : "memory");
}

// a ring position: slot and the parity of its current phase
struct RingPos {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int n) {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Grid (ctas, splits), TC_THREADS threads: warps 0-7 two consumer
// warpgroups (pixels 64*wg .. +63 of a tile), warp 8 the producer. With
// splits > 1 the grid's y is one cluster and each CTA takes one tile;
// else each CTA walks tiles blockIdx.x, += gridDim.x. With resident
// weights (one n tile, splits = 1) the producer loads every weight stage
// once, on the weights' barrier, and the ring carries pixels alone.
template <int BN>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_s8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, int32_t* __restrict__ out,
                     const TcArgs a) {
  using P = TcConv<BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nst = P::nst(a.resident);
  const uint32_t stage = a.resident ? TC_A_BYTES : P::STAGE;
  const uint32_t raw = smem_u32(smem);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t wres = ring + (uint32_t)nst * stage;        // resident weights
  const uint32_t full = wres + (uint32_t)a.resident, empty = full + 8 * P::MAX_NST;
  const uint32_t wfull = empty + 8 * P::MAX_NST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int splits = static_cast<int>(gridDim.y);
  // this CTA's stages of K, shared as evenly as whole stages allow
  const int s0 = a.stages * static_cast<int>(blockIdx.y) / splits;
  const int s1 = a.stages * static_cast<int>(blockIdx.y + 1) / splits;

  if (threadIdx.x == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, TC_CONSUMER_WARPS);
    }
    mbar_init(wfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == TC_CONSUMER_WARPS) {
    // the producer: the stages of the CTA's walk go round the ring, each
    // into its slot once both warpgroups have freed it
    if (lane == 0) {
      prefetch_tensormap(&xmap);
      prefetch_tensormap(&wmap);
      if (a.resident) {
        mbar_expect_tx(wfull, (uint32_t)a.resident);
        for (int s = 0; s < a.stages; ++s)
          tma_load_2d(wres + (uint32_t)(s * P::B_BYTES), &wmap, s * TC_BK, 0, wfull);
      }
      const int per_img = a.OH * a.OW;
      RingPos pos;
      int it = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const int mt = t / a.n_tiles, n0 = (t - mt * a.n_tiles) * BN;
        // the tile's first pixel (image, output row, column) and its
        // top-left tap in x, which may lie in the padding
        const int m0 = mt * TC_BM;
        const int img = m0 / per_img, r = m0 - img * per_img;
        const int oh = r / a.OW;
        const int h0 = oh * a.stride - a.pad, w0 = (r - oh * a.OW) * a.stride - a.pad;
        for (int s = s0; s < s1; ++s, ++it, pos.next(nst)) {
          if (it >= nst) mbar_wait(empty + 8 * pos.slot, pos.phase ^ 1);
          const uint32_t st = ring + (uint32_t)pos.slot * stage, bar = full + 8 * pos.slot;
          // K bytes kb .. kb+127: one load of 128 channels of a tap, or
          // one load a tap of C < 128 channels, up to K's end (the
          // weights past it are zeros)
          const int kb = s * TC_BK;
          const int loads = min(TC_BK, a.K - kb) / a.cb;
          mbar_expect_tx(bar, (uint32_t)(loads * TC_BM * a.cb) +
                                  (a.resident ? 0u : (uint32_t)P::B_BYTES));
          for (int j = 0; j < loads; ++j) {
            const int k = kb + j * a.cb, tap = k >> a.lc, kh = tap / a.KS;
            tma_load_im2col(st + (uint32_t)(j * TC_BM * a.cb), &xmap, k & ((1 << a.lc) - 1),
                            w0, h0, img, (uint16_t)(tap - kh * a.KS), (uint16_t)kh, bar);
          }
          if (!a.resident) tma_load_2d(st + TC_A_BYTES, &wmap, kb, n0, bar);
        }
      }
    }
    __syncwarp();
    if (splits > 1) {             // the two cluster barriers of the split sum
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  const int wg = warp >> 2, wi = warp & 3;
  // A's descriptors: rows of cb bytes in the swizzle of that span (layout
  // 1, 2, 3 for 128, 64, 32 bytes; 0, none, at 16, where a k32 step's two
  // 16-byte halves are two loads apart); k32 step kk at load kk*32 / cb,
  // byte kk*32 % cb of its rows; this warpgroup's 64 rows from row 64*wg
  const uint32_t box = (uint32_t)(TC_BM * a.cb);
  const uint32_t a_layout = a.cb == 128 ? 1 : a.cb == 64 ? 2 : a.cb == 32 ? 3 : 0;
  const uint32_t a_lbo = a.cb == 16 ? box : 16, a_sbo = 8 * (uint32_t)a.cb;
  uint32_t a_off[TC_BK / 32];
#pragma unroll
  for (int kk = 0; kk < TC_BK / 32; ++kk)
    a_off[kk] = (uint32_t)(32 * kk / a.cb) * box + (uint32_t)(32 * kk % a.cb) +
                (uint32_t)(wg * 64 * a.cb);
  if (a.resident) mbar_wait(wfull, 0);
  int acc[BN / 2];
  RingPos pos, prev;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int mt = t / a.n_tiles, n0 = (t - mt * a.n_tiles) * BN;
    const int m0 = mt * TC_BM;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_acc(acc);
    for (int s = s0; s < s1; ++s) {
      const uint32_t st = ring + (uint32_t)pos.slot * stage;
      const uint32_t b_st = a.resident ? wres + (uint32_t)(s * P::B_BYTES) : st + TC_A_BYTES;
      mbar_wait(full + 8 * pos.slot, pos.phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 32; ++kk)
        wgmma_s8<BN>(acc, smem_desc(st + a_off[kk], a_lbo, a_sbo, a_layout),
                     smem_desc(b_st + 32 * kk, 16, 1024, 1));
      wgmma_commit();
      wgmma_wait<1>();                 // the stage before is read
      if (s > s0 && lane == 0) mbar_arrive(empty + 8 * prev.slot);
      prev = pos;
      pos.next(nst);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * prev.slot);
    fence_acc(acc);

    // lane l holds pixels 16*wi + l/4 (+8) of the warpgroup's 64, channels
    // 8j + 2(l%4) and the next of each n8 block j
    const int lr = wg * 64 + wi * 16 + (lane >> 2), lc2 = 2 * (lane & 3);
    if (splits == 1) {
      const int m = m0 + lr;
      int32_t* o = out + (size_t)m * a.O + n0 + lc2;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (n0 + 8 * j < a.O) {        // O % 8 == 0: a block is in or out
          if (m < a.M) *reinterpret_cast<int2*>(o + 8 * j) = make_int2(acc[4 * j], acc[4 * j + 1]);
          if (m + 8 < a.M)
            *reinterpret_cast<int2*>(o + 8 * (size_t)a.O + 8 * j) =
                make_int2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      continue;
    }
    // split K: this CTA's partial tile into the ring, whose stages every
    // wgmma of both warpgroups has read; then CTA `rank` of the cluster
    // sums the row groups rank, rank + splits, ... over every CTA's tile,
    // its loads of the splits' partial tiles in flight together
    consumers_sync();
    int* cs = reinterpret_cast<int*>(smem + (ring - raw));
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<int2*>(cs + lr * P::CSTR + 8 * j + lc2) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(cs + (lr + 8) * P::CSTR + 8 * j + lc2) =
          make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    cluster.sync();                    // every partial tile is in place
    constexpr int TPR = BN / 4;        // threads a pixel: 16 bytes each
    constexpr int RPP = TC_CONSUMERS / TPR;
    const int er = threadIdx.x / TPR, ec = (threadIdx.x % TPR) * 4;
    if (er < RPP && n0 + ec < a.O) {
      for (int g = rank; g * RPP < TC_BM; g += splits) {
        const int r = g * RPP + er;
        if (r >= TC_BM || m0 + r >= a.M) break;
        int4 p[MAX_SPLITS];
#pragma unroll
        for (int q = 0; q < MAX_SPLITS; ++q)
          if (q < splits)
            p[q] = *reinterpret_cast<const int4*>(
                cluster.map_shared_rank(cs + r * P::CSTR + ec, q));
        int4 v = p[0];
#pragma unroll
        for (int q = 1; q < MAX_SPLITS; ++q)
          if (q < splits) {
            v.x += p[q].x; v.y += p[q].y; v.z += p[q].z; v.w += p[q].w;
          }
        *reinterpret_cast<int4*>(out + (size_t)(m0 + r) * a.O + n0 + ec) = v;
      }
    }
    cluster.sync();                    // no CTA leaves while its tile is read
  }
}

template <int BN>
int launch_tc(cudaStream_t s, const CUtensorMap& xmap, const CUtensorMap& wmap, void* out,
              const TcArgs& a, int ctas, int splits) {
  static bool set[64] = {};
  auto kernel = conv_s8_wgmma_kernel<BN>;
  if (int err = allow_smem(kernel, set)) return err;
  // the splits of a tile are one cluster of (1, splits, 1) CTAs
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, splits);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = TcConv<BN>::smem(a.resident);
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, static_cast<int32_t*>(out), a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The tensor maps, kept across calls: the served paths run the same
// weights and, from the caching allocator, the same activation buffers
// again and again, and a map encodes only the pointer, the shape and the
// box, so a hit on those is the map itself, whatever the tensor now holds.
// Each cache is cleared when it grows past 4096 entries.
std::mutex map_mutex;
std::map<std::array<int64_t, 4>, CUtensorMap> wmap_cache;
std::map<std::array<int64_t, 12>, CUtensorMap> xmap_cache;

// w (O, K) in boxes of `rows` rows x 128 bytes
int weight_map(const void* w, int O, int K, int rows, CUtensorMap* map) {
  const std::array<int64_t, 4> key = {reinterpret_cast<int64_t>(w), O, K, rows};
  std::lock_guard<std::mutex> lock(map_mutex);
  const auto hit = wmap_cache.find(key);
  if (hit != wmap_cache.end()) {
    *map = hit->second;
    return 0;
  }
  if (int err = encode_s8_2d(map, w, (uint64_t)O, (uint64_t)K, (uint32_t)rows)) return err;
  if (wmap_cache.size() >= 4096) wmap_cache.clear();
  wmap_cache.emplace(key, *map);
  return 0;
}

// x (N, H, W, C) as im2col loads of box = {lower w, lower h, upper w,
// upper h, traversal stride, pixels, channels}
int input_map(const void* x, int N, int H, int W, int C, const int* box, CUtensorMap* map) {
  const std::array<int64_t, 12> key = {reinterpret_cast<int64_t>(x), N, H, W, C, box[0],
                                       box[1], box[2], box[3], box[4], box[5], box[6]};
  std::lock_guard<std::mutex> lock(map_mutex);
  const auto hit = xmap_cache.find(key);
  if (hit != xmap_cache.end()) {
    *map = hit->second;
    return 0;
  }
  const int lower[2] = {box[0], box[1]}, upper[2] = {box[2], box[3]};
  if (int err = encode_s8_im2col(map, x, (uint64_t)N, (uint64_t)H, (uint64_t)W, (uint64_t)C,
                                 lower, upper, (uint32_t)box[4], (uint32_t)box[5],
                                 (uint32_t)box[6]))
    return err;
  if (xmap_cache.size() >= 4096) xmap_cache.clear();
  xmap_cache.emplace(key, *map);
  return 0;
}

// The plan, checked: tiles of 128 pixels x bn channels over `ctas` CTAs,
// K in `splits` shares (a cluster along y, one tile a CTA), the weights
// resident in shared memory or not (`resident`: one n tile, unsplit, and
// ring room for at least TC_MIN_NST stages of pixels beside them); box:
// x's im2col box.
int launch_tensor_cores(cudaStream_t s, const void* x, const void* w, void* out, int N, int H,
                        int W, int C, int O, int ks, int stride, int pad, int OH, int OW,
                        int bn, int splits, int resident, int ctas, const int* box) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (C < 16 || (C & (C - 1)) || splits < 1 || splits > MAX_SPLITS || ctas < 1 ||
      box == nullptr || box[4] != stride || box[5] != TC_BM ||
      box[6] != (C < TC_BK ? C : TC_BK))
    return bad;
  TcArgs a;
  a.M = N * OH * OW;
  a.O = O;
  a.K = ks * ks * C;
  a.OH = OH;
  a.OW = OW;
  a.stride = stride;
  a.pad = pad;
  a.KS = ks;
  a.lc = __builtin_ctz(static_cast<unsigned>(C));
  a.cb = box[6];
  a.stages = (a.K + TC_BK - 1) / TC_BK;
  a.n_tiles = (O + bn - 1) / bn;
  a.tiles = (a.M + TC_BM - 1) / TC_BM * a.n_tiles;
  a.resident = resident ? a.stages * bn * TC_BK : 0;
  if (splits > a.stages || (splits > 1 && ctas != a.tiles) || ctas > a.tiles ||
      (resident && (splits > 1 || a.n_tiles > 1 ||
                    SMEM_MAX - 2048 - a.resident < TC_MIN_NST * TC_A_BYTES)))
    return bad;
  CUtensorMap xmap, wmap;
  if (int err = input_map(x, N, H, W, C, box, &xmap)) return err;
  if (int err = weight_map(w, O, a.K, bn, &wmap)) return err;
  switch (bn) {
    case 8: return launch_tc<8>(s, xmap, wmap, out, a, ctas, splits);
    case 16: return launch_tc<16>(s, xmap, wmap, out, a, ctas, splits);
    case 24: return launch_tc<24>(s, xmap, wmap, out, a, ctas, splits);
    case 32: return launch_tc<32>(s, xmap, wmap, out, a, ctas, splits);
    case 48: return launch_tc<48>(s, xmap, wmap, out, a, ctas, splits);
    case 64: return launch_tc<64>(s, xmap, wmap, out, a, ctas, splits);
    case 96: return launch_tc<96>(s, xmap, wmap, out, a, ctas, splits);
    case 128: return launch_tc<128>(s, xmap, wmap, out, a, ctas, splits);
    default: return bad;
  }
}

// ---------------------------------------------------------------------------
// the CUDA-core routes: row bands (C <= 8 dense; depthwise)

constexpr int BAND_THREADS = 256;
constexpr int RING = 4;             // input buffers: a band and 3 ahead

__host__ __device__ constexpr int align16(int v) { return (v + 15) & ~15; }

// Shared memory that a run of n bytes copied by `copy_run` takes.
__host__ __device__ constexpr int run_bytes(int n) { return align16(n + 15); }

// Shared-memory layout of a CTA of the dense route, in bytes: the weights
// of its ch output channels (as they lie in w, then as words), RING raw
// buffers (a band's input rows as they lie in x) and the word tile they
// are unpacked into (CW words of channels a pixel, a zero column either
// side). The wrapper's `_band_smem` is the same sum.
struct DenseBand {
  int wts, words, raw, tile;
  __host__ __device__ DenseBand(int W, int cin, int ks, int stride, int rows, int ch) {
    const int ir = (rows - 1) * stride + ks;
    const int cw = (cin + 3) / 4;
    wts = run_bytes(ch * ks * ks * cin);
    words = ch * ks * ks * cw * 4;
    raw = run_bytes(ir * W * cin);
    tile = align16(ir * (W + 2) * cw * 4);
  }
  __host__ __device__ int bytes() const { return wts + words + RING * raw + tile; }
};

// ... of a CTA of the depthwise route: the weights of its ch channels and
// RING byte tiles (a band's input rows, ch channels a pixel, a zero column
// either side).
struct DwBand {
  int wts, tile;
  __host__ __device__ DwBand(int W, int stride, int rows, int ch) {
    wts = run_bytes(ch * 9);
    tile = align16(((rows - 1) * stride + 3) * (W + 2) * ch);
  }
  __host__ __device__ int bytes() const { return wts + RING * tile; }
};

// `bytes` (0..16) of src to dst and zeros to the rest of its 16 bytes
// (cp.async's src-size: nothing past them is read)
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// cp.async of bytes start .. end-1 of src (16-byte aligned) to dst, from the
// 16-byte word at or below start, so that byte start lands at dst + (start
// & 15); the last word is cut at end (src-size): nothing past it is read.
// Every thread of the CTA calls it; the caller commits.
__device__ __forceinline__ void copy_run(unsigned char* dst, const int8_t* src,
                                         size_t start, size_t end) {
  if (end <= start) return;
  const size_t base = start & ~static_cast<size_t>(15);
  const int words = static_cast<int>((end - base + 15) / 16);
  for (int i = threadIdx.x; i < words; i += BAND_THREADS) {
    const size_t at = base + 16 * (size_t)i;
    cp_async16_n(smem_u32(dst + 16 * i), src + at,
                 static_cast<int>(end - at < 16 ? end - at : 16));
  }
}

// V (16, 8 or 4) bytes of src to dst when `valid`, else V zeros and
// nothing read
template <int V>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, bool valid) {
  if constexpr (V == 16)
    cp_async16_zfill(dst, src, valid);
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(V), "r"(valid ? V : 0));
}

// One band: output rows oh0 .. oh0+nrows-1 of image img.
struct Band {
  int img, oh0, nrows;
  __device__ Band(int b, int rows, int OH) {
    const int per_img = (OH + rows - 1) / rows;
    img = b / per_img;
    oh0 = (b - img * per_img) * rows;
    nrows = min(rows, OH - oh0);
  }
};

// The dense route, C = cin <= 8 (the stems' 3 channels, 8-channel inputs):
// K = KS*KS*CW words of 4 input channels (channels past cin read as 0), O
// tiled by OT channels (blockIdx.y), the bands walked by a persistent CTA
// (blockIdx.x, += gridDim.x) with the input rows of the next RING - 1
// bands in flight. Thread t holds output channels c0 + 4(t % OT/4) .. +3,
// and their K weight words in registers, for every pixel it sums: pixels
// t / (OT/4), + BAND_THREADS / (OT/4), ... of the band. At K = 18 words
// (3x3, 5 to 8 channels) the 72 weight registers take one CTA an SM, so
// that nothing spills.
template <int KS, int CW, int OT>
__global__ void __launch_bounds__(BAND_THREADS, KS * KS * CW > 9 ? 1 : 2)
conv_s8_band_dp4a_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                         int32_t* __restrict__ out, int H, int W, int cin, int O,
                         int OH, int OW, int stride, int pad, int rows, int bands) {
  constexpr int K = KS * KS * CW;
  constexpr int QT = OT / 4;                 // channel quads of the tile
  extern __shared__ __align__(16) unsigned char smem[];
  const DenseBand L(W, cin, KS, stride, rows, OT);
  // the weights as they lie in w, their words, raw buffer k at raw0 +
  // k*L.raw, the tile (offsets, not arrays of pointers, which would go to
  // the stack)
  uint32_t* wwords = reinterpret_cast<uint32_t*>(smem + L.wts);
  unsigned char* raw0 = smem + L.wts + L.words;
  int* tile = reinterpret_cast<int*>(raw0 + RING * L.raw);
  const int tid = threadIdx.x;
  const int q = tid % QT;
  const int c0 = blockIdx.y * OT;
  const bool q_ok = c0 + 4 * q < O;          // this thread's channels exist
  const int TW = W + 2;                      // tile columns: x's, and a zero
                                             // column either side
  const int kb = KS * KS * cin;              // weight bytes a channel

  // a band's input rows ih_lo .. ih_lo + ir - 1, of which those in the
  // image (a .. e-1) are one run of x's bytes
  auto in_rows = [&](const Band& bd, int& ih_lo, int& ir, int& a, int& e) {
    ih_lo = bd.oh0 * stride - pad;
    ir = (bd.nrows - 1) * stride + KS;
    a = max(ih_lo, 0);
    e = min(ih_lo + ir, H);
  };
  auto load_raw = [&](int b, int slot) {
    if (b >= bands) return;
    const Band bd(b, rows, OH);
    int ih_lo, ir, a, e;
    in_rows(bd, ih_lo, ir, a, e);
    copy_run(raw0 + slot * L.raw, x, ((size_t)bd.img * H + a) * W * cin,
             ((size_t)bd.img * H + max(a, e)) * W * cin);
  };

  // the weights of channels c0 .. c0+OT-1 below O arrive with the first
  // band's rows (group 0); group g holds the rows of the CTA's band g
  copy_run(smem, w, (size_t)c0 * kb, (size_t)min(O, c0 + OT) * kb);
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    load_raw(blockIdx.x + s * gridDim.x, s);
    cp_async_commit();
  }
  cp_async_wait<RING - 2>();                 // group 0 landed
  __syncthreads();
  {
    // word k = (tap, cw) of channel c holds input channels 4cw .. 4cw+3 of
    // that tap, bytes past cin 0: built once, each by one thread
    const unsigned char* ws = smem + ((size_t)c0 * kb & 15);
    for (int i = tid; i < OT * K; i += BAND_THREADS) {
      const int c = i / K, k = i - c * K;
      const int t = k / CW, cw = k - t * CW;
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + c < O && 4 * cw + e < cin)
          v |= static_cast<uint32_t>(ws[c * kb + t * cin + 4 * cw + e]) << (8 * e);
      wwords[i] = v;
    }
  }
  __syncthreads();
  uint32_t wr[4][K];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) wr[j][k] = wwords[(4 * q + j) * K + k];

  int it = 0;
  for (int b = blockIdx.x; b < bands; b += gridDim.x, ++it) {
    const Band bd(b, rows, OH);
    cp_async_wait<RING - 2>();               // this band's raw rows landed
    __syncthreads();                         // ... for every thread, and the
                                             // last band's tile is summed
    load_raw(b + (RING - 1) * gridDim.x, (it + RING - 1) % RING);
    cp_async_commit();

    // unpack: tile word (row, col, cw) = input channels 4cw .. 4cw+3 of
    // pixel (ih_lo + row, col - 1); 0 off the image and past cin
    {
      int ih_lo, ir, a, e;
      in_rows(bd, ih_lo, ir, a, e);
      const unsigned char* rb = raw0 + (it % RING) * L.raw +
                                (((size_t)bd.img * H + a) * W * cin & 15);
      for (int r = 0; r < ir; ++r) {
        const int ih = ih_lo + r;
        const bool row_ok = ih >= a && ih < e;
        const unsigned char* rrow = rb + (ih - a) * W * cin;
        for (int i = tid; i < TW * CW; i += BAND_THREADS) {
          const int col = i / CW, cw = i - col * CW;
          const int iw = col - 1;
          uint32_t v = 0;
          if (row_ok && (unsigned)iw < (unsigned)W) {
            const unsigned char* px = rrow + iw * cin + 4 * cw;
            if (cin % 4 == 0) {              // cin 4 or 8: the word is aligned
              v = *reinterpret_cast<const uint32_t*>(px);
            } else {
#pragma unroll
              for (int e2 = 0; e2 < 4; ++e2)
                if (4 * cw + e2 < cin) v |= static_cast<uint32_t>(px[e2]) << (8 * e2);
            }
          }
          tile[r * TW * CW + i] = static_cast<int>(v);
        }
      }
    }
    __syncthreads();

    int32_t* ob = out + ((size_t)bd.img * OH + bd.oh0) * OW * O + c0 + 4 * q;
    if (q_ok) {
      const int step = BAND_THREADS / QT;
      int r = 0, ow = tid / QT;
      for (int p = ow; p < bd.nrows * OW; p += step, ow += step) {
        while (ow >= OW) { ow -= OW; ++r; }
        const int* tp = tile + ((r * stride) * TW + ow * stride - pad + 1) * CW;
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kh = 0; kh < KS; ++kh)
#pragma unroll
          for (int kw = 0; kw < KS; ++kw)
#pragma unroll
            for (int cw = 0; cw < CW; ++cw) {
              const int v = tp[(kh * TW + kw) * CW + cw];
              const int k = (kh * KS + kw) * CW + cw;
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[j] = __dp4a(v, static_cast<int>(wr[j][k]), acc[j]);
            }
        *reinterpret_cast<int4*>(ob + (size_t)p * O) = make_int4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
  }
}

// The depthwise route (groups = C = O, 3x3): channels tiled by ch (a
// multiple of 4 dividing C; blockIdx.y), the bands walked as above.
// Thread t sums channels c0 + 4(t % Q) .. +3 (Q = ch/4 quads) of pixels
// t / Q, + BAND_THREADS / Q, ...: one 4-byte word of the tile a tap. The
// 4 x 4 bytes of taps 0-3 (and 4-7) are transposed with __byte_perm so
// that one __dp4a sums 4 taps of a channel; tap 8 takes one __dp4a a
// channel against a weight word that holds the channel's byte alone.
// V: the bytes of one cp.async (16, 8 or 4, as C and ch allow).
template <int V>
__global__ void __launch_bounds__(BAND_THREADS, 2)
conv_s8_band_dw_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       int32_t* __restrict__ out, int H, int W, int C, int OH,
                       int OW, int stride, int pad, int rows, int ch, int bands) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DwBand L(W, stride, rows, ch);
  // the weights, then tile k at tile0 + k*L.tile
  unsigned char* tile0 = smem + L.wts;
  const int tid = threadIdx.x;
  const int Q = ch / 4;
  const int step = BAND_THREADS / Q;         // pixels summed at once
  const int q = tid % Q;
  const int c0 = blockIdx.y * ch;
  const int TW = W + 2;
  const int CQ = ch / 4;                     // tile words a pixel

  // cp.async of a band's tile: rows ih_lo .., columns -1 .. W, channels
  // c0 .. c0+ch-1; off the image zero-filled, nothing read
  auto load_tile = [&](int b, int slot) {
    if (b >= bands) return;
    unsigned char* dst = tile0 + slot * L.tile;
    const Band bd(b, rows, OH);
    const int ih_lo = bd.oh0 * stride - pad;
    const int ir = (bd.nrows - 1) * stride + 3;
    const int units = ch / V;
    for (int i = tid; i < ir * TW * units; i += BAND_THREADS) {
      const int px = i / units, u = i - px * units;
      const int r = px / TW, col = px - r * TW;
      const int ih = ih_lo + r, iw = col - 1;
      const bool ok = (unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W;
      const int8_t* src = ok ? x + (((size_t)bd.img * H + ih) * W + iw) * C + c0 + u * V : x;
      cp_async_zfill<V>(smem_u32(dst + px * ch + u * V), src, ok);
    }
  };

  // the weights of channels c0 .. c0+ch-1 (w is (C, 3, 3, 1): 9 bytes a
  // channel) arrive with the first band's tile (group 0); group g holds
  // the tile of the CTA's band g
  copy_run(smem, w, (size_t)c0 * 9, (size_t)(c0 + ch) * 9);
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    load_tile(blockIdx.x + s * gridDim.x, s);
    cp_async_commit();
  }
  uint32_t wa[4], wb[4], w8[4];
  int it = 0;
  for (int b = blockIdx.x; b < bands; b += gridDim.x, ++it) {
    const Band bd(b, rows, OH);
    cp_async_wait<RING - 2>();               // this band's tile landed
    __syncthreads();                         // ... for every thread, and the
                                             // last band's tile is summed
    load_tile(b + (RING - 1) * gridDim.x, (it + RING - 1) % RING);
    cp_async_commit();

    if (it == 0 && tid < step * Q) {
      // weights of channels c0+4q .. +3: taps 0-3 and 4-7 a word each,
      // tap 8 in byte j of w8[j]
      const unsigned char* ws = smem + ((size_t)c0 * 9 & 15);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* wc = ws + (4 * q + j) * 9;
        uint32_t u[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) u[t] = wc[t];
        wa[j] = u[0] | u[1] << 8 | u[2] << 16 | u[3] << 24;
        wb[j] = u[4] | u[5] << 8 | u[6] << 16 | u[7] << 24;
        w8[j] = u[8] << (8 * j);
      }
    }

    const uint32_t* tile = reinterpret_cast<const uint32_t*>(tile0 + (it % RING) * L.tile);
    int32_t* ob = out + ((size_t)bd.img * OH + bd.oh0) * OW * C + c0 + 4 * q;
    if (tid < step * Q) {
      int r = 0, ow = tid / Q;
      for (int p = ow; p < bd.nrows * OW; p += step, ow += step) {
        while (ow >= OW) { ow -= OW; ++r; }
        const uint32_t* tp = tile + ((r * stride) * TW + ow * stride - pad + 1) * CQ + q;
        uint32_t v[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) v[t] = tp[((t / 3) * TW + t % 3) * CQ];
        int acc[4];
        // bytes j of taps 0-3 (4-7) to word j: one channel's 4 taps
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const uint32_t* s = v + 4 * g;
          const uint32_t lo01 = __byte_perm(s[0], s[1], 0x5140);
          const uint32_t hi01 = __byte_perm(s[0], s[1], 0x7362);
          const uint32_t lo23 = __byte_perm(s[2], s[3], 0x5140);
          const uint32_t hi23 = __byte_perm(s[2], s[3], 0x7362);
          const uint32_t tr[4] = {__byte_perm(lo01, lo23, 0x5410),
                                  __byte_perm(lo01, lo23, 0x7632),
                                  __byte_perm(hi01, hi23, 0x5410),
                                  __byte_perm(hi01, hi23, 0x7632)};
          const uint32_t* wg = g ? wb : wa;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = __dp4a(static_cast<int>(tr[j]), static_cast<int>(wg[j]),
                            g ? acc[j] : 0);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = __dp4a(static_cast<int>(v[8]), static_cast<int>(w8[j]), acc[j]);
        *reinterpret_cast<int4*>(ob + (size_t)p * C) = make_int4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
  }
}

template <int KS, int CW, int OT>
int launch_band_dp4a(cudaStream_t s, const void* x, const void* w, void* out, int N,
                     int H, int W, int cin, int O, int OH, int OW, int stride,
                     int pad, int rows, int ctas) {
  static bool set[64] = {};
  auto kernel = conv_s8_band_dp4a_kernel<KS, CW, OT>;
  if (int err = allow_smem(kernel, set)) return err;
  const int bands = N * ((OH + rows - 1) / rows);
  const int smem = DenseBand(W, cin, KS, stride, rows, OT).bytes();
  kernel<<<dim3(min(ctas, bands), (O + OT - 1) / OT), BAND_THREADS, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), H, W, cin, O, OH, OW, stride, pad, rows, bands);
  return static_cast<int>(cudaGetLastError());
}

template <int KS, int CW>
int launch_band_dp4a_ot(cudaStream_t s, const void* x, const void* w, void* out, int N,
                        int H, int W, int cin, int O, int OH, int OW, int stride,
                        int pad, int rows, int ch, int ctas) {
  switch (ch) {
    case 8: return launch_band_dp4a<KS, CW, 8>(s, x, w, out, N, H, W, cin, O, OH, OW, stride, pad, rows, ctas);
    case 16: return launch_band_dp4a<KS, CW, 16>(s, x, w, out, N, H, W, cin, O, OH, OW, stride, pad, rows, ctas);
    case 32: return launch_band_dp4a<KS, CW, 32>(s, x, w, out, N, H, W, cin, O, OH, OW, stride, pad, rows, ctas);
    default: return launch_band_dp4a<KS, CW, 64>(s, x, w, out, N, H, W, cin, O, OH, OW, stride, pad, rows, ctas);
  }
}

template <int V>
int launch_band_dw(cudaStream_t s, const void* x, const void* w, void* out, int N,
                   int H, int W, int C, int OH, int OW, int stride, int pad,
                   int rows, int ch, int ctas) {
  static bool set[64] = {};
  auto kernel = conv_s8_band_dw_kernel<V>;
  if (int err = allow_smem(kernel, set)) return err;
  const int bands = N * ((OH + rows - 1) / rows);
  const int smem = DwBand(W, stride, rows, ch).bytes();
  kernel<<<dim3(min(ctas, bands), C / ch), BAND_THREADS, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), H, W, C, OH, OW, stride, pad, rows, ch, bands);
  return static_cast<int>(cudaGetLastError());
}

// an empty kernel: the floor of a launch's device time
__global__ void launch_floor_kernel() {}

}  // namespace

// C entry point (loaded with ctypes). Launches on `stream` and returns the
// CUDA error as an int; it never synchronizes. The caller has checked: x
// (N, H, W, C) and w (O, ks, ks, C / groups) int8 and out (N, OH, OW, O)
// int32, all contiguous and 16-byte aligned; ks in {1, 3}; O a multiple of
// 8; N*OH*OW*O and N*H*W*C below 2**31; K = ks*ks*C / groups small enough
// that no int32 sum overflows. groups = C (= O, ks = 3, C a multiple of 4)
// runs the depthwise band kernel. Else the plans are the wrapper's: bn = 0
// runs the dense band kernel, which takes C <= 8; bn > 0 (a width of
// TcConv) runs the tensor-core kernel, which takes C a power of two >= 16,
// in tiles of 128 pixels x bn channels over `ctas` CTAs, K in `splits`
// (1..8) clusters' shares, the weights `resident` in shared memory or not
// (launch_tensor_cores), x read through the im2col box `box` (7 ints: the
// lower corner in w and h, the upper corner in w and h, the traversal
// stride, the pixels and the channels of a load; `_im2col_box`). A band
// kernel takes bands of `rows` output rows and `ch` output channels (the
// dense route: 8, 16, 32 or 64; the depthwise one: a multiple of 4
// dividing C, at most 4 * BAND_THREADS) over at most `ctas` CTAs along the
// bands (`_band_plan`).
extern "C" int facekit_conv_s8(const void* x, const void* w, void* out,
                               int N, int H, int W, int C, int O, int ks,
                               int stride, int pad, int OH, int OW, int groups,
                               int bn, int splits, int resident, int rows, int ch,
                               int ctas, const int* box, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (groups > 1) {
    if (groups != C || O != C || ks != 3 || C % 4 || rows < 1 || ctas < 1 ||
        ch < 4 || ch % 4 || C % ch || ch > 4 * BAND_THREADS ||
        DwBand(W, stride, rows, ch).bytes() > SMEM_MAX)
      return bad;
    if (C % 16 == 0 && ch % 16 == 0)
      return launch_band_dw<16>(s, x, w, out, N, H, W, C, OH, OW, stride, pad, rows, ch, ctas);
    if (C % 8 == 0 && ch % 8 == 0)
      return launch_band_dw<8>(s, x, w, out, N, H, W, C, OH, OW, stride, pad, rows, ch, ctas);
    return launch_band_dw<4>(s, x, w, out, N, H, W, C, OH, OW, stride, pad, rows, ch, ctas);
  }
  if (O % 8) return bad;
  if (bn == 0) {
    if (C < 1 || C > 8 || rows < 1 || ctas < 1 ||
        (ch != 8 && ch != 16 && ch != 32 && ch != 64) ||
        DenseBand(W, C, ks, stride, rows, ch).bytes() > SMEM_MAX)
      return bad;
    if (ks == 1)
      return C <= 4 ? launch_band_dp4a_ot<1, 1>(s, x, w, out, N, H, W, C, O, OH, OW, stride, pad, rows, ch, ctas)
                    : launch_band_dp4a_ot<1, 2>(s, x, w, out, N, H, W, C, O, OH, OW, stride, pad, rows, ch, ctas);
    return C <= 4 ? launch_band_dp4a_ot<3, 1>(s, x, w, out, N, H, W, C, O, OH, OW, stride, pad, rows, ch, ctas)
                  : launch_band_dp4a_ot<3, 2>(s, x, w, out, N, H, W, C, O, OH, OW, stride, pad, rows, ch, ctas);
  }
  return launch_tensor_cores(s, x, w, out, N, H, W, C, O, ks, stride, pad, OH, OW, bn, splits,
                             resident, ctas, box);
}

// The dynamic shared memory (bytes) of a CTA of a band kernel at this
// shape and plan: groups > 1 the depthwise route, else the dense one.
extern "C" int facekit_conv_s8_band_smem(int groups, int W, int C, int ks,
                                         int stride, int rows, int ch) {
  return groups > 1 ? DwBand(W, stride, rows, ch).bytes()
                    : DenseBand(W, C, ks, stride, rows, ch).bytes();
}

// The most clusters of `size` CTAs of the tensor-core kernel (128 wide,
// its ring of shared memory, K split along y) that the current device
// runs at once, as cudaOccupancyMaxActiveClusters gives it (the split
// plan's `_cluster_ctas` must not count more); or -(the CUDA error).
extern "C" int facekit_conv_s8_max_clusters(int size) {
  static bool set[64] = {};
  auto kernel = conv_s8_wgmma_kernel<128>;
  if (int err = allow_smem(kernel, set)) return -err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = size;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, size);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = TcConv<128>::smem(0);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// One empty kernel of one CTA on `stream`: what a launch costs the card
// with no work (chip_smoke.py's floor for the band kernels' small sites).
extern "C" int facekit_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
