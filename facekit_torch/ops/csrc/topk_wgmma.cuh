// The tensor-core pass 1 that every gallery search runs at B > 8: bf16 and
// f32 (cosine_topk.cu) and int8 (cosine_topk_int8.cu). One kernel,
// templated on the operand type, so that the three cannot diverge, as
// facekit's two Pallas search kernels share `_fold_tile`
// (facekit/ops/similarity.py:127-133) and the port's share topk_fold.cuh.
// The producer warp, the score-tile hand-off and the selection warps are
// the same code for all three; only the warpgroups' products differ.
//
// A CTA takes one tile of WQ queries (bf16 and s8 64, f32 32) and one
// chunk of rows; the grid is (query tiles, chunks) with the query tile in
// blockIdx.x, so the CTAs that read the same rows run together and all but
// the first find them in L2: the gallery leaves HBM about once. Bound on
// an H100 SXM: the rows the search needs, read once (bf16 1.07 GB at N =
// 1,048,576, 0.32 ms; int8 with its scales 0.54 GB, 0.16 ms; f32 2.15 GB,
// 0.64 ms), or the 2*B*N*D operations: bf16 and s8 reach the bytes' time
// only past B of about 300 and 600; f32 needs three TF32 passes (3xTF32,
// 495 TFLOPS), 1.67 ms at B = 256, and at 32 queries a CTA the gallery is
// read 8 times from L2 there (17.2 GB), which at the 4-7 TB/s the card's
// L2 gives its SMs is the likelier floor.
//
//  * One producer warp keeps a ring of stages (WR = 128 rows x 128 bytes
//    of K, the 128-byte swizzle) full by TMA loads of a 2-D tensor map over
//    the gallery's rows, on a full and an empty mbarrier a slot. The ring
//    takes what shared memory is left: in bf16 6 stages at k = 1, 3 at
//    k = 64; in s8, where a row tile is 4 stages, 8 and 5; in f32, where a
//    row tile is 16 stages, 4 and 3 (static_asserts below). Rows past the
//    tensor's end arrive as zeros; rows at or past `count` are masked by
//    index.
//  * bf16 and s8: one warpgroup issues wgmma.mma_async m64n128k16 (bf16 ->
//    f32) or m64n128k32 (s8 -> s32) over each stage, both operands K-major
//    from shared memory through descriptors: A the query tile, loaded once
//    (slots past the batch zero) in the swizzled layout, B the stage. The
//    accumulators (64 registers a thread) hold the whole 64 x 128 score
//    tile across D = 512; one stage of wgmma stays in flight while the next
//    stage's barrier is awaited, and a slot is freed once its wgmma are
//    done. In s8 the sum is an exact integer (|acc| <= 127^2 * 512 < 2^24).
//  * f32: 64 f32 queries as A would take 262,144 bytes split into hi and
//    lo, more than a CTA may have, so the roles swap: the gallery rows are
//    A, from registers, and 32 queries are B (N = 32), split once into a hi
//    and a lo tile (131,072 bytes). Two warpgroups each take one 64-row
//    half of the 128-row tile: a thread loads its A fragment of a stage
//    (two rows, 32 bytes each, as two 16-byte loads: K is permuted within
//    each 32-float stage so that a thread's eight values of a row lie
//    together, and the query tile is written in the same order), splits
//    each value into hi (x rounded to 11 significant bits) and lo = x - hi
//    (split_tf32, as the query tile is split: with hi = the top 19 bits,
//    split_tf32_trunc, near-tied rows came back in another order than the
//    plain version's) and frees the slot. Each k8 step issues three
//    wgmma.mma_async m64n32k8 tf32 (lo*hi, hi*lo, hi*hi): 3xTF32, about 22
//    bits of each product where one pass keeps 11. The tensor cores round
//    toward zero as they accumulate, so a chain of 192 products per score
//    drifts past an f32 sum's error; each stage (4 k8 steps) sums into a
//    fresh accumulator (scale-d 0 on its first wgmma), then added to the
//    score's, rounded to nearest. Each k8 step is a commit group, and one
//    stays in flight while the next step's fragments are split (two sets
//    of A fragments); two sets of stage accumulators are used in turn, so
//    that a stage is folded into the scores while the next one's products
//    run. 13 warps leave a thread 128 registers (a quarter of the SM's
//    register file holds 4 of them), which three groups in flight
//    overran. The scores come out as rows x queries.
//  * Every score sums its K steps in the same order with the same
//    instructions (no split K), so equal rows get bit-equal scores wherever
//    they fall.
//  * The warpgroups write a row tile's scores to one of two score tiles in
//    shared memory, used in turn (f32 at k > 1: one, for a deeper ring;
//    -1e30 past count; in s8 f32(acc) *
//    q_scale), query-major whatever the type, and go on to the next row
//    tile's products at once; the selection warps (8 in bf16 and s8, 4 in
//    f32: 8 queries a warp either way), on their own mbarriers (a full and
//    an empty one a score tile), offer the tile to the sorted top-k of
//    their queries (one list per query per CTA: warp w keeps queries w,
//    w + SEL_WARPS, ...), in s8 after multiplying by g_scale (the plain
//    version's two multiplies in its order; the scales loaded a tile ahead,
//    each row's once a warp). A query's 128 scores are filtered against its
//    list's k-th entry at once, so that a tile without a winner costs a
//    vote; at k > 1 the winners go to a buffer of 32 per query, merged into
//    the list in one step when full (topk_fold.cuh warp_append,
//    warp_flush). The selection loops stay rolled: unrolled over a warp's 8
//    queries the code grew and the selection ran slower (PERF.md). A
//    query's row of a score tile is permuted within each 32 columns (XOR
//    by col_swz) so that the warpgroups' stores and the selection warps'
//    loads meet no bank conflict.
// The CTA writes its lists as the (B, chunks, k) partials of the CUDA-core
// kernels, which pass 2 (topk_fold.cuh) reduces.

#pragma once

#include <array>
#include <map>
#include <mutex>
#include <type_traits>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "topk_fold.cuh"

namespace {

constexpr int WR = 128;                     // gallery rows per row tile
constexpr int WKB = 128;                    // bytes of K per stage (the swizzle's span)
constexpr int W_STAGE = WR * WKB;           // bytes of a stage
constexpr int W_MAX_NST = 8;                // most stages in the ring
constexpr int W_THREADS = 416;              // warpgroups, selection warps, producer
constexpr int W_SMEM_MAX = 232448;          // the dynamic shared memory a CTA may take
constexpr int W_BAR_BYTES = 8 * (2 * W_MAX_NST + 4);

// The shapes and the layout of pass 1 for operand type T, uint16_t (bf16
// bits), int8_t or float, at top k: from the 1024-aligned base of dynamic
// shared memory (the 128-byte swizzle's span of 8 rows), the query tile
// (WQ rows in blocks of 128 bytes of K, each block WQ x 128 bytes; f32: a
// hi tile, then a lo tile), the ring of nst stages, nsc score tiles, the
// lists (WQ x k scores, then WQ x k indices), at k > 1 each query's buffer
// (32 scores, 32 indices), the buffers' fills, then the barriers: full and
// empty a slot, full and empty a score tile.
template <typename T>
struct WgTile {
  static constexpr bool S8 = std::is_same_v<T, int8_t>;
  static constexpr bool F32 = std::is_same_v<T, float>;
  using Acc = std::conditional_t<S8, int, float>;
  static constexpr int WQ = F32 ? 32 : 64;            // queries per CTA
  static constexpr int MMA_THREADS = F32 ? 256 : 128; // the warpgroups
  static constexpr int SEL_WARPS = F32 ? 4 : 8;       // the selection warps
  static constexpr int PRODUCER = W_THREADS / 32 - 1; // the producer's warp
  static constexpr int ROW = D * (int)sizeof(T);      // bytes of a row
  static constexpr int KSTAGES = ROW / WKB;           // stages per row tile
  static constexpr int Q_BLOCK = WQ * WKB;            // bytes of a query block
  static constexpr int Q_HALF = WQ * ROW;             // bytes of the (hi) tile
  static constexpr int Q_BYTES = (F32 ? 2 : 1) * Q_HALF;
  // arrivals that free a slot: bf16 and s8 lane 0 of each warpgroup warp
  // once its wgmma have read the stage; f32 every thread once it has
  // loaded its A fragments
  static constexpr int EMPTY_ARRIVALS = F32 ? MMA_THREADS : MMA_THREADS / 32;
  static constexpr int SCORES = WQ * WR * 4;          // bytes of a score tile
  static constexpr int NACC = WQ / 2;                 // f32: a thread's WQ / 8 n8 blocks
  static constexpr int BUF_BYTES = WQ * 32 * 8;       // k > 1: the buffers
  static_assert(MMA_THREADS + 32 * SEL_WARPS + 32 == W_THREADS, "416 threads");
  static_assert(WQ % SEL_WARPS == 0 && WQ % 8 == 0, "queries shared by the selection warps");

  // score tiles at top k: two, used in turn; one in f32 at k > 1, where
  // a ring of 2 stages beside two held the CTA back more than the
  // selection warps' lost slack (PERF.md)
  __host__ __device__ static constexpr int nsc(int k) { return F32 && k > 1 ? 1 : 2; }
  // the bytes past the ring
  __host__ __device__ static constexpr int rest(int k) {
    return nsc(k) * SCORES + WQ * k * 8 + (k > 1 ? BUF_BYTES : 0) + WQ * 4 + W_BAR_BYTES;
  }
  __host__ __device__ static constexpr int nst(int k) {
    return (W_SMEM_MAX - Q_BYTES - rest(k)) / W_STAGE < W_MAX_NST
               ? (W_SMEM_MAX - Q_BYTES - rest(k)) / W_STAGE
               : W_MAX_NST;
  }
  __host__ __device__ static constexpr int smem(int k) {
    return Q_BYTES + nst(k) * W_STAGE + rest(k);
  }
  // a query's row of a score tile holds column n at n ^ col_swz(q): the
  // queries that one store instruction of the warpgroups writes fall in
  // distinct banks (bf16 and s8: a thread holds queries q and q + 8 of
  // columns n, n + 1; f32: queries q, q + 1 of rows n, n + 8)
  __host__ __device__ static constexpr int col_swz(int q) {
    return F32 ? 8 * ((q >> 1) & 3) : 8 * (q & 3);
  }
  static_assert(smem(KMAX) <= W_SMEM_MAX && smem(1) <= W_SMEM_MAX, "a CTA fits");
  static_assert(Q_BYTES % 1024 == 0 && W_STAGE % 1024 == 0,
                "the swizzled operands stay 1024-aligned");
};

static_assert(WgTile<uint16_t>::nst(KMAX) == 3 && WgTile<uint16_t>::nst(1) == 6,
              "bf16: a ring of 3 stages at k = 64, 6 at k = 1");
static_assert(WgTile<int8_t>::nst(KMAX) == 5 && WgTile<int8_t>::nst(1) == 8,
              "s8: a ring of 5 stages at k = 64, 8 at k = 1");
// the layouts that similarity.py's pass1_layout mirrors (the CPU tests
// hold it to these numbers)
static_assert(WgTile<float>::Q_BYTES == 131072 && WgTile<float>::SCORES == 16384 &&
                  WgTile<float>::rest(1) == 33312 && WgTile<float>::rest(KMAX) == 41248,
              "f32: a 131,072-byte query tile, 16,384-byte score tiles");
static_assert(WgTile<float>::nst(1) == 4 && WgTile<float>::nst(2) == 4 &&
                  WgTile<float>::nst(KMAX) == 3,
              "f32: a ring of 4 stages at k = 1 and 2, 3 at k = 64");
static_assert(WgTile<float>::smem(1) == 229920 && WgTile<float>::smem(KMAX) == 221472,
              "f32: the shared memory a CTA takes at k = 1 and k = 64");

// d += the stage's products, one wgmma per 32 bytes of K: bf16 m64n128k16,
// s8 m64n128k32
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_m64n128k16(d, da, db);
}
__device__ __forceinline__ void wgmma_step(int (&d)[64], uint64_t da, uint64_t db) {
  wgmma_s8<128>(d, da, db);
}

// The query tile into shared memory at qs, slots past the batch zero. bf16
// and s8: 16-byte chunk c of row r at block c / 8, chunk (c % 8) ^ (r % 8)
// of the row's 128 bytes there. f32: the hi tile, then the lo tile
// (split_tf32), each in blocks of one stage's 32 floats of K, the
// K of a block permuted as the gallery's A fragments read it: the k8 step
// kk's column c (chunk 2kk + c / 4, word c % 4 of the row's 128 bytes,
// before the swizzle) holds element 8 (c % 4) + 2 kk + c / 4 of the block,
// so chunk h's word w holds element 8 w + h.
template <typename T>
__device__ __forceinline__ void load_query_tile(unsigned char* qs, const char* queries,
                                                int q0, int nq) {
  using P = WgTile<T>;
  constexpr int ROW = P::ROW;
  for (int e = threadIdx.x; e < P::WQ * (ROW / 16); e += W_THREADS) {
    const int r = e / (ROW / 16), c = e % (ROW / 16);
    const int at = (c >> 3) * P::Q_BLOCK + r * WKB + (((c & 7) ^ (r & 7)) << 4);
    if constexpr (P::F32) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u), lo = v;
      if (r < nq) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(
                                  queries + (size_t)(q0 + r) * ROW) + (c >> 3) * 32 + (c & 7);
        v = make_uint4(__ldg(src), __ldg(src + 8), __ldg(src + 16), __ldg(src + 24));
      }
      split_tf32(v.x, v.x, lo.x); split_tf32(v.y, v.y, lo.y);
      split_tf32(v.z, v.z, lo.z); split_tf32(v.w, v.w, lo.w);
      *reinterpret_cast<uint4*>(qs + at) = v;
      *reinterpret_cast<uint4*>(qs + P::Q_HALF + at) = lo;
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nq) v = __ldg(reinterpret_cast<const uint4*>(queries + (size_t)(q0 + r) * ROW) + c);
      *reinterpret_cast<uint4*>(qs + at) = v;
    }
  }
}

// Offer query j's row of a score tile (rows row0 .. row0 + 127; those
// before `end`; column n at n ^ swz) to its sorted list lv/li of length k;
// gs: the lane's rows' s8 scales (1 in bf16, f32 and past count). The
// lane's four scores (rows 32u + lane) are filtered at once against the
// list's k-th entry, so a tile with no winner, the common case once the
// list has filled, costs six loads and one vote. At k = 1 the winners go
// to warp_offer, 32 rows at a time in ascending order; at k > 1 to the
// query's buffer bv/bi, holding *cnt, which is merged into the list in one
// step when full (warp_append, warp_flush: the list becomes the top k of
// both, whatever the order they came in), and once more after the last
// tile. The rare path stays a rolled loop: the selection warps' code is
// kept small.
__device__ __forceinline__ void offer_tile(float* lv, int* li, float* bv, int* bi, int* cnt,
                                           int k, const float* sc_row, int swz,
                                           const float (&gs)[WR / 32], int row0, int end,
                                           int lane) {
  float v[WR / 32];
  bool ok[WR / 32];
  const float tv = lv[k - 1];
  const int ti = li[k - 1];
  bool hit = false;
#pragma unroll
  for (int u = 0; u < WR / 32; ++u) {
    const int n = 32 * u + lane;
    v[u] = sc_row[n ^ swz] * gs[u];
    ok[u] = row0 + n < end && beats(v[u], row0 + n, tv, ti);
    hit |= ok[u];
  }
  if (!__any_sync(FULL, hit)) return;
  int c = *cnt;
#pragma unroll 1
  for (int u = 0; u < WR / 32; ++u) {
    const float vu = u == 0 ? v[0] : u == 1 ? v[1] : u == 2 ? v[2] : v[3];
    const bool oku = u == 0 ? ok[0] : u == 1 ? ok[1] : u == 2 ? ok[2] : ok[3];
    if (k == 1) {
      warp_offer(lv, li, k, vu, row0 + 32 * u + lane, oku, lane);
    } else {
      const unsigned m = __ballot_sync(FULL, oku);
      if (m) warp_append(lv, li, bv, bi, c, k, vu, row0 + 32 * u + lane, oku, m, lane);
    }
  }
  if (lane == 0) *cnt = c;
  __syncwarp();
}

// Grid (query tiles of WQ, chunks of rows_per_cta rows, a multiple of WR),
// W_THREADS threads: the warpgroups (warps 0-3 in bf16 and s8, 0-7 in f32),
// then the selection warps, then the producer (warp 12). gmap: the
// gallery's rows, boxes of WR rows x 128 bytes. gscale and qscale (the s8
// rows' and queries' f32 scales) are read in s8 only.
template <typename T>
__global__ void __launch_bounds__(W_THREADS, 1)
topk_partial_wgmma_kernel(const __grid_constant__ CUtensorMap gmap,
                          const float* __restrict__ gscale,
                          const char* __restrict__ queries,
                          const float* __restrict__ qscale,
                          int n_rows, int count, int B, int k, int rows_per_cta,
                          float* __restrict__ part_v, int* __restrict__ part_i) {
  using P = WgTile<T>;
  using Acc = typename P::Acc;
  constexpr int KSTAGES = P::KSTAGES, WQ = P::WQ;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const int nst = P::nst(k), nsc = P::nsc(k);
  const uint32_t qtile = smem_u32(smem_wg);
  if (qtile & 1023) __trap();     // the swizzled operands need the alignment
  const uint32_t ring = qtile + P::Q_BYTES;
  float* scores = reinterpret_cast<float*>(smem_wg + P::Q_BYTES + nst * W_STAGE);
  float* list_v = scores + nsc * WQ * WR;
  int* list_i = reinterpret_cast<int*>(list_v + WQ * k);
  float* buf_v = reinterpret_cast<float*>(list_i + WQ * k);     // k > 1: (WQ, 32)
  int* buf_i = reinterpret_cast<int*>(buf_v + (k > 1 ? WQ * 32 : 0));
  int* buf_n = buf_i + (k > 1 ? WQ * 32 : 0);                    // (WQ,) their fill
  const uint32_t full = smem_u32(buf_n + WQ);
  const uint32_t empty = full + 8 * W_MAX_NST;
  const uint32_t sfull = empty + 8 * W_MAX_NST, sempty = sfull + 16;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * WQ;
  const int nq = min(WQ, B - q0);
  const int chunk = blockIdx.y, chunks = gridDim.y;
  const int begin = chunk * rows_per_cta;
  const int end = min(begin + rows_per_cta, n_rows);
  const int tiles = end > begin ? (end - begin + WR - 1) / WR : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, P::EMPTY_ARRIVALS);
    }
    for (int b = 0; b < nsc; ++b) {
      mbar_init(sfull + 8 * b, P::MMA_THREADS);
      mbar_init(sempty + 8 * b, 32 * P::SEL_WARPS);
    }
    mbar_fence_init();
  }
  load_query_tile<T>(smem_wg, queries, q0, nq);
  fence_proxy_async();            // the tile's writes before the wgmma read it
  __syncthreads();

  if (warp == P::PRODUCER) {
    // stage g (row tile g / KSTAGES, 128 bytes of K from (g % KSTAGES) *
    // 128) into slot g % nst, once the warpgroups have freed it
    if (lane == 0) {
      prefetch_tensormap(&gmap);
      int slot = 0;
      uint32_t phase = 0;
      for (int g = 0; g < tiles * KSTAGES; ++g) {
        if (g >= nst) mbar_wait(empty + 8 * slot, phase ^ 1);
        mbar_expect_tx(full + 8 * slot, W_STAGE);
        tma_load_2d(ring + (uint32_t)(slot * W_STAGE), &gmap,
                    (g % KSTAGES) * (WKB / (int)sizeof(T)), begin + (g / KSTAGES) * WR,
                    full + 8 * slot);
        if (++slot == nst) { slot = 0; phase ^= 1; }
      }
    }
    return;
  }

  if (warp < P::MMA_THREADS / 32) {
    // The score tile hand-off: row tile t's scores go to score tile
    // t % nsc once the selection warps are done with tile t - nsc, then
    // the selection warps are told; -1e30 past count.
    auto score_tile = [&](int t) {
      const int b = t % nsc;
      if (t >= nsc) mbar_wait(sempty + 8 * b, (t / nsc - 1) & 1);
      return scores + b * WQ * WR;
    };
    auto score_tile_done = [&](int t) {
      const int b = t % nsc;
      mbar_arrive(sfull + 8 * b);
    };
    int slot = 0;
    uint32_t phase = 0;
    if constexpr (P::F32) {
      // warpgroup h takes rows 64h .. 64h + 63 of each row tile: lane l of
      // its warp w holds rows ra = 64h + 16w + l/4 and ra + 8 of the
      // accumulators, queries 8j + 2(l%4) and the next of each n8 block j;
      // of a stage it loads elements 8(l%4) .. 8(l%4) + 7 of rows ra and
      // ra + 8 (chunks 2(l%4), 2(l%4) + 1 before the swizzle)
      const int ra = 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2);
      const int t4 = lane & 3;
      const uint32_t off0 = ra * WKB + (((2 * t4) ^ (ra & 7)) << 4);
      const uint32_t off1 = ra * WKB + (((2 * t4 + 1) ^ (ra & 7)) << 4);
      const int swz = P::col_swz(2 * t4);             // that of each of its queries
      float acc[P::NACC], part0[P::NACC], part1[P::NACC];
      uint32_t ah0[4], al0[4], ah1[4], al1[4];      // even and odd k8 steps' A
#pragma unroll
      for (int i = 0; i < P::NACC; ++i) part0[i] = part1[i] = acc[i] = 0.f;

      // Stage g's sums, its wgmma done, into the score's (a select, not
      // a branch, at a row tile's first stage: ptxas serializes the wgmma
      // where their registers meet a divergent path); after a row tile's
      // last stage its scores go to a score tile
      auto fold = [&](int g, float (&d)[P::NACC]) {
        fence_acc(d);
        const int ks = g % KSTAGES;
#pragma unroll
        for (int i = 0; i < P::NACC; ++i) acc[i] = __fadd_rn(ks == 0 ? 0.f : acc[i], d[i]);
        if (ks < KSTAGES - 1) return;
        const int t = g / KSTAGES;
        const int row0 = begin + t * WR;
        float* sc = score_tile(t);
        const bool la = row0 + ra < count, lb = row0 + ra + 8 < count;
#pragma unroll
        for (int j = 0; j < P::WQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* col = sc + (8 * j + 2 * t4 + e) * WR;
            col[ra ^ swz] = la ? acc[4 * j + e] : NEG_INF;
            col[(ra + 8) ^ swz] = lb ? acc[4 * j + 2 + e] : NEG_INF;
          }
        }
        score_tile_done(t);
      };
      // One k8 step kk of stage g into the stage accumulators d from A
      // fragments ah/al, split from x (row ra) and y (row ra + 8), values
      // 2(kk%2) and the next of each, once wgmma_wait<1> has seen the group
      // that last read them (step kk - 2) done: lo*hi, hi*lo, hi*hi, the
      // stage's first with scale-d 0, one commit group. So one group stays
      // in flight while the next step's fragments are split.
      auto step = [&](int kk, uint32_t q, float (&d)[P::NACC], uint32_t (&ah)[4],
                      uint32_t (&al)[4], const uint4& x, const uint4& y) {
        const bool odd = kk & 1;
        // a0 (row ra, column l%4), a1 (ra + 8), a2 (ra, l%4 + 4), a3
        split_tf32(odd ? x.z : x.x, ah[0], al[0]);
        split_tf32(odd ? y.z : y.x, ah[1], al[1]);
        split_tf32(odd ? x.w : x.y, ah[2], al[2]);
        split_tf32(odd ? y.w : y.y, ah[3], al[3]);
        wgmma_fence();
        wgmma_tf32<P::WQ>(d, al, smem_desc(q + 32 * kk, 16, 1024, 1), kk > 0);
        wgmma_tf32<P::WQ>(d, ah, smem_desc(q + P::Q_HALF + 32 * kk, 16, 1024, 1), 1);
        wgmma_tf32<P::WQ>(d, ah, smem_desc(q + 32 * kk, 16, 1024, 1), 1);
        wgmma_commit();
      };
      // Stage g into the stage accumulators d (stage g - 2's, folded first
      // where `folds`): a thread's values of rows ra and ra + 8, two
      // 16-byte loads a row (steps 0-1, then 2-3); the slot is freed once
      // the last values are split.
      auto stage = [&](int g, float (&d)[P::NACC], auto folds) {
        mbar_wait(full + 8 * slot, phase);
        const unsigned char* st = smem_wg + P::Q_BYTES + slot * W_STAGE;
        // the stage's block of the hi tile (the lo tile's Q_HALF on)
        const uint32_t q = qtile + (uint32_t)((g % KSTAGES) * P::Q_BLOCK);
        uint4 x = *reinterpret_cast<const uint4*>(st + off0);
        uint4 y = *reinterpret_cast<const uint4*>(st + off0 + 8 * WKB);
        wgmma_wait<1>();
        if constexpr (decltype(folds)::value) fold(g - 2, d);
        step(0, q, d, ah0, al0, x, y);
        wgmma_wait<1>();
        step(1, q, d, ah1, al1, x, y);
        x = *reinterpret_cast<const uint4*>(st + off1);
        y = *reinterpret_cast<const uint4*>(st + off1 + 8 * WKB);
        wgmma_wait<1>();
        step(2, q, d, ah0, al0, x, y);
        wgmma_wait<1>();
        step(3, q, d, ah1, al1, x, y);
        mbar_arrive(empty + 8 * slot);          // this thread's loads are done
        if (++slot == nst) { slot = 0; phase ^= 1; }
      };
      // stages in pairs, the even ones on the first set of stage
      // accumulators
      const int total = tiles * KSTAGES;            // even: KSTAGES is 16
      if (total > 0) {
        stage(0, part0, std::false_type());
        stage(1, part1, std::false_type());
        for (int g = 2; g < total; g += 2) {
          stage(g, part0, std::true_type());
          stage(g + 1, part1, std::true_type());
        }
        wgmma_wait<0>();
        fold(total - 2, part0);
        fold(total - 1, part1);
      }
    } else {
      // lane l of warp w holds queries 16w + l/4 and 16w + l/4 + 8, columns
      // 8j + 2(l%4) and the next of each n8 block j of the 128
      const int qa = 16 * warp + (lane >> 2);
      float q_sc[2] = {0.f, 0.f};
      if constexpr (P::S8) {
        q_sc[0] = qa < nq ? __ldg(qscale + q0 + qa) : 0.f;
        q_sc[1] = qa + 8 < nq ? __ldg(qscale + q0 + qa + 8) : 0.f;
      }
      Acc acc[64];
      for (int t = 0; t < tiles; ++t) {
        const int row0 = begin + t * WR;
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0;
        fence_acc(acc);
        int prev = -1;
        for (int ks = 0; ks < KSTAGES; ++ks) {
          mbar_wait(full + 8 * slot, phase);
          const uint32_t st = ring + (uint32_t)(slot * W_STAGE);
          const uint32_t qa_st = qtile + (uint32_t)(ks * P::Q_BLOCK);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < WKB / 32; ++kk)
            wgmma_step(acc, smem_desc(qa_st + 32 * kk, 16, 1024, 1),
                       smem_desc(st + 32 * kk, 16, 1024, 1));
          wgmma_commit();
          wgmma_wait<1>();                     // the stage before is read
          if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
          prev = slot;
          if (++slot == nst) { slot = 0; phase ^= 1; }
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
        fence_acc(acc);

        // in s8 f32(acc) * q_scale: the selection warps multiply by
        // g_scale, each row's once a warp
        float* sc = score_tile(t);
        const int swz0 = P::col_swz(qa), swz1 = P::col_swz(qa + 8);
#pragma unroll
        for (int j = 0; j < WR / 8; ++j) {
          const int n = 8 * j + 2 * (lane & 3);
          const bool l0 = row0 + n < count, l1 = row0 + n + 1 < count;
          float v[4];
          if constexpr (P::S8) {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = static_cast<float>(acc[4 * j + e]) * q_sc[e >> 1];
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = acc[4 * j + e];
          }
          *reinterpret_cast<float2*>(sc + qa * WR + (n ^ swz0)) =
              make_float2(l0 ? v[0] : NEG_INF, l1 ? v[1] : NEG_INF);
          *reinterpret_cast<float2*>(sc + (qa + 8) * WR + (n ^ swz1)) =
              make_float2(l0 ? v[2] : NEG_INF, l1 ? v[3] : NEG_INF);
        }
        score_tile_done(t);
      }
    }
    return;
  }

  // the selection warps: warp sw keeps the lists of queries sw,
  // sw + SEL_WARPS, ...
  const int sw = warp - P::MMA_THREADS / 32;
  for (int j = sw; j < nq; j += P::SEL_WARPS) {
    for (int s = lane; s < k; s += 32) {
      list_v[j * k + s] = NEG_INF;
      list_i[j * k + s] = BIG_IDX;
    }
    if (lane == 0) buf_n[j] = 0;
  }
  __syncwarp();
  // s8: the scales of the lane's rows of the next tile, loaded while this
  // one is offered; 1 past count (the scores there are -1e30 already)
  auto row_scales = [&](int t, float (&gs)[WR / 32]) {
#pragma unroll
    for (int u = 0; u < WR / 32; ++u) {
      const int row = begin + t * WR + 32 * u + lane;
      gs[u] = P::S8 && t < tiles && row < count ? __ldg(gscale + row) : 1.f;
    }
  };
  float gs_next[WR / 32];
  row_scales(0, gs_next);
  for (int t = 0; t < tiles; ++t) {
    const int b = t % nsc;
    const int row0 = begin + t * WR;
    float gs[WR / 32];
#pragma unroll
    for (int u = 0; u < WR / 32; ++u) gs[u] = gs_next[u];
    row_scales(t + 1, gs_next);
    mbar_wait(sfull + 8 * b, (t / nsc) & 1);
    const float* sc = scores + b * WQ * WR;
#pragma unroll 1
    for (int j = sw; j < nq; j += P::SEL_WARPS)
      offer_tile(list_v + j * k, list_i + j * k, buf_v + 32 * j, buf_i + 32 * j, buf_n + j, k,
                 sc + j * WR, P::col_swz(j), gs, row0, end, lane);
    mbar_arrive(sempty + 8 * b);
  }
  for (int j = sw; j < nq; j += P::SEL_WARPS) {
    if (buf_n[j])
      warp_flush(list_v + j * k, list_i + j * k, buf_v + 32 * j, buf_i + 32 * j, buf_n[j], k,
                 lane);
  }
  for (int j = sw; j < nq; j += P::SEL_WARPS) {
    const size_t off = ((size_t)(q0 + j) * chunks + chunk) * k;
    for (int s = lane; s < k; s += 32) {
      part_v[off + s] = list_v[j * k + s];
      part_i[off + s] = list_i[j * k + s];
    }
  }
}

// The gallery's tensor maps, kept across calls: a search runs over the
// same gallery again and again, and a map encodes only the pointer, the
// rows and the type, so a hit on those is the map itself, whatever the
// rows now hold. Cleared when it grows past 4096 entries.
std::mutex gmap_mutex;
std::map<std::array<int64_t, 3>, CUtensorMap> gmap_cache;

// gallery (rows, D) of T in boxes of WR rows x 128 bytes, the 128-byte
// swizzle; rows past `rows` arrive as zeros
template <typename T>
int gallery_map(const void* gallery, int rows, CUtensorMap* map) {
  const std::array<int64_t, 3> key = {reinterpret_cast<int64_t>(gallery), rows,
                                      (int64_t)sizeof(T)};
  std::lock_guard<std::mutex> lock(gmap_mutex);
  const auto hit = gmap_cache.find(key);
  if (hit != gmap_cache.end()) {
    *map = hit->second;
    return 0;
  }
  const int err = WgTile<T>::S8    ? encode_s8_2d(map, gallery, (uint64_t)rows, D, WR)
                  : WgTile<T>::F32 ? encode_f32_2d(map, gallery, (uint64_t)rows, D, WR)
                                   : encode_bf16_2d(map, gallery, (uint64_t)rows, D, WR,
                                                    WKB / (int)sizeof(T));
  if (err) return err;
  if (gmap_cache.size() >= 4096) gmap_cache.clear();
  gmap_cache.emplace(key, *map);
  return 0;
}

// Pass 1 on warpgroup tensor cores: grid (ceil(B / WQ), chunks) over the
// gallery's first n_rows of its gallery_rows rows. Returns the CUDA error
// of encoding the map, of setting the shared-memory size or of the launch,
// as an int.
template <typename T>
int launch_partial_wgmma(int chunks, cudaStream_t s, const void* gallery, int gallery_rows,
                         const void* gscale, const void* queries, const void* qscale,
                         int n_rows, int count, int B, int k, int rows_per_cta,
                         void* part_v, void* part_i) {
  static bool set[64] = {};
  auto kernel = topk_partial_wgmma_kernel<T>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !set[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) set[dev] = true;
  }
  CUtensorMap map;
  if (int err = gallery_map<T>(gallery, gallery_rows, &map)) return err;
  const dim3 grid((B + WgTile<T>::WQ - 1) / WgTile<T>::WQ, chunks);
  kernel<<<grid, W_THREADS, WgTile<T>::smem(k), s>>>(
      map, static_cast<const float*>(gscale), static_cast<const char*>(queries),
      static_cast<const float*>(qscale), n_rows, count, B, k, rows_per_cta,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
