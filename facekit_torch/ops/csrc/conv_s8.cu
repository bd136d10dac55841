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
// the CUDA-core routes: row bands (C <= 8 dense; depthwise)

constexpr int BAND_THREADS = 256;
constexpr int SMEM_MAX = 232448;    // the dynamic shared memory a CTA may take
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
// runs the dense band kernel, which takes C <= 8; bn = 128 (O a multiple
// of 128) or 64 runs the tensor-core kernel, which takes C a power of two
// >= 16, in `splits` (1..8) runs of `per_split` stages of K covering them
// all. A band kernel takes bands of `rows` output rows and `ch` output
// channels (the dense route: 8, 16, 32 or 64; the depthwise one: a
// multiple of 4 dividing C, at most 4 * BAND_THREADS) over at most `ctas`
// CTAs along the bands (`_band_plan`).
extern "C" int facekit_conv_s8(const void* x, const void* w, void* out,
                               int N, int H, int W, int C, int O, int ks,
                               int stride, int pad, int OH, int OW, int groups,
                               int bn, int splits, int per_split, int rows,
                               int ch, int ctas, void* stream) {
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
  if (C < 16 || (C & (C - 1)) || splits < 1 || splits > MAX_SPLITS) return bad;
  const int log2_c = __builtin_ctz(static_cast<unsigned>(C));
  const int M = N * OH * OW;
  if (ks == 1)
    return bn == 128 ? launch_mma<1, 128>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M, splits, per_split)
                     : launch_mma<1, 64>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M, splits, per_split);
  return bn == 128 ? launch_mma<3, 128>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M, splits, per_split)
                   : launch_mma<3, 64>(s, x, w, out, H, W, log2_c, O, OH, OW, stride, pad, M, splits, per_split);
}

// The dynamic shared memory (bytes) of a CTA of a band kernel at this
// shape and plan: groups > 1 the depthwise route, else the dense one.
extern "C" int facekit_conv_s8_band_smem(int groups, int W, int C, int ks,
                                         int stride, int rows, int ch) {
  return groups > 1 ? DwBand(W, stride, rows, ch).bytes()
                    : DenseBand(W, C, ks, stride, rows, ch).bytes();
}

// One empty kernel of one CTA on `stream`: what a launch costs the card
// with no work (chip_smoke.py's floor for the band kernels' small sites).
extern "C" int facekit_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
