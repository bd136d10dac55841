// The tensor-core pass 1 that both gallery searches run at B > 8 in bf16
// (cosine_topk.cu) and in int8 (cosine_topk_int8.cu): one kernel,
// templated on the operand type, so that the two cannot diverge, as
// facekit's two Pallas search kernels share `_fold_tile`
// (facekit/ops/similarity.py:127-133) and the port's share topk_fold.cuh.
// The f32 search at B > 8 keeps its 3xTF32 mma.sync kernel (topk_mma.cuh).
//
// A CTA takes one tile of WQ = 64 queries and one chunk of rows; the grid
// is (query tiles, chunks) with the query tile in blockIdx.x, so the CTAs
// that read the same rows run together and all but the first find them in
// L2: the gallery leaves HBM about once. Bound on an H100 SXM: the rows
// the search needs, read once (bf16 1.07 GB at N = 1,048,576, 0.32 ms;
// int8 with its scales 0.54 GB, 0.16 ms); the 2*B*N*D operations reach
// that time only past B of about 300 (bf16) and 600 (int8).
//
// What held back the mma.sync kernel this replaces (pass 1 at int8 B = 64
// k = 1 2.7x its bound, bf16 B = 256 at 12 % of the bf16 peak), and what
// this one does about it:
//  * Every thread issued cp.async copies of 16 bytes into a ring of 4
//    stages and met the others at a __syncthreads every stage; in s8 the
//    ring held less than one row tile. Here one producer warp keeps a ring
//    of stages (WR = 128 rows x 128 bytes of K, the 128-byte swizzle) full
//    by TMA loads of a 2-D tensor map over the gallery's rows, on a full
//    and an empty mbarrier a slot. The ring takes what shared memory is
//    left: in bf16 6 stages at k = 1, 3 at k = 64; in s8, where a row tile
//    is 4 stages, 8 at k = 1, 5 at k = 64. Rows past the tensor's end
//    arrive as zeros; rows at or past `count` are masked by index below.
//  * Every warp issued ldmatrix and mma.sync m16n8k16 / m16n8k32. Here one
//    warpgroup issues wgmma.mma_async m64n128k16 (bf16 -> f32) or
//    m64n128k32 (s8 -> s32) over each stage, both operands K-major from
//    shared memory through descriptors: A the query tile, loaded once (slots
//    past the batch zero) in the swizzled layout, B the stage. The
//    accumulators (64 registers a thread) hold the whole 64 x 128 score
//    tile across D = 512; one stage of wgmma stays in flight while the next
//    stage's barrier is awaited, and a slot is freed once its wgmma are
//    done. Every score sums its K steps in the same order with the same
//    instructions (no split K), so equal rows get bit-equal scores wherever
//    they fall; in s8 the sum is an exact integer (|acc| <= 127^2 * 512 <
//    2^24).
//  * After each row tile all warps wrote the scores to shared memory, met,
//    and offered them to the lists while no product ran. Here the
//    warpgroup writes the tile's scores to one of two score tiles in
//    shared memory, used in turn (-1e30 past count; in s8 f32(acc) *
//    q_scale), and goes on to the next row tile's products at once; eight
//    selection warps, on their own mbarriers (a full and an empty one a
//    score tile), offer the tile to the sorted top-k of their queries (one
//    list per query per CTA, 8 queries a warp: warp w keeps queries w,
//    w + 8, ...), in s8 after multiplying by g_scale (the plain version's
//    two multiplies in its order; the scales loaded a tile ahead, each row's
//    once a warp, where 32 loads a thread in the warpgroup's store took
//    longer than its products). A query's 128 scores are filtered against
//    its list's k-th entry at once, so that a tile without a winner costs
//    a vote (the selection this replaces, 32 rows a ballot against a
//    threshold reloaded each time, took as long per CTA as the rows' bytes
//    at int8 B = 64 k = 1); at k > 1 the winners go to a buffer of 32 per
//    query, merged into the list in one step when full (topk_fold.cuh
//    warp_append, warp_flush), where one insertion at a time made k = 64
//    4x as slow as k = 1 and a merge per tile slower still. The selection
//    loops stay rolled: unrolled over a warp's 8 queries the code grew and
//    the selection ran slower (PERF.md). The score tile's columns are
//    permuted by 8 * (query % 4) within each 32, so that the warpgroup's
//    stores and the selection warps' loads meet no bank conflict.
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

constexpr int WR = 128;                     // gallery rows per row tile: wgmma N
constexpr int WQ = 64;                      // queries per CTA: wgmma M
constexpr int WKB = 128;                    // bytes of K per stage (the swizzle's span)
constexpr int W_STAGE = WR * WKB;           // bytes of a stage
constexpr int W_SCORES = WQ * WR * 4;       // bytes of a score tile
constexpr int W_MAX_NST = 8;                // most stages in the ring
constexpr int W_SEL_WARPS = 8;              // selection warps
constexpr int W_MMA_THREADS = 128;          // the wgmma warpgroup
constexpr int W_THREADS = W_MMA_THREADS + 32 * W_SEL_WARPS + 32;   // and the producer
constexpr int W_PRODUCER = W_THREADS / 32 - 1;                      // its warp
constexpr int W_SMEM_MAX = 232448;          // the dynamic shared memory a CTA may take
constexpr int W_BUF_BYTES = WQ * 32 * 8;  // at k > 1 each query's buffer of 32 (v, i)
constexpr int W_BAR_BYTES = 8 * (2 * W_MAX_NST + 4);

// The layout of pass 1 for operand type T, uint16_t (bf16 bits) or int8_t,
// at top k: from the 1024-aligned base of dynamic shared memory (the
// 128-byte swizzle's span of 8 rows), the query tile (64 rows in blocks of
// 128 bytes of K, each block 64 x 128 bytes), the ring of nst stages, two
// score tiles, the lists (WQ x k scores, then WQ x k indices), at k > 1 each
// query's buffer (32 scores, 32 indices), the buffers' fills, then the
// barriers: full and empty a slot, full and empty a score tile.
template <typename T>
struct WgTile {
  static constexpr bool S8 = std::is_same_v<T, int8_t>;
  using Acc = std::conditional_t<S8, int, float>;
  static constexpr int ROW = D * (int)sizeof(T);      // bytes of a row
  static constexpr int KSTAGES = ROW / WKB;           // stages per row tile
  static constexpr int Q_BYTES = WQ * ROW;
  static constexpr int Q_BLOCK = WQ * WKB;            // bytes of a query block

  // the bytes past the ring
  __host__ __device__ static constexpr int rest(int k) {
    return 2 * W_SCORES + WQ * k * 8 + (k > 1 ? W_BUF_BYTES : 0) + WQ * 4 + W_BAR_BYTES;
  }
  __host__ __device__ static constexpr int nst(int k) {
    return (W_SMEM_MAX - Q_BYTES - rest(k)) / W_STAGE < W_MAX_NST
               ? (W_SMEM_MAX - Q_BYTES - rest(k)) / W_STAGE
               : W_MAX_NST;
  }
  __host__ __device__ static constexpr int smem(int k) {
    return Q_BYTES + nst(k) * W_STAGE + rest(k);
  }
  static_assert(nst(KMAX) >= 3 && nst(1) >= 6, "a ring of 3 stages or more");
  static_assert(smem(KMAX) <= W_SMEM_MAX && smem(1) <= W_SMEM_MAX, "a CTA fits");
};

// d += the stage's products, one wgmma per 32 bytes of K: bf16 m64n128k16,
// s8 m64n128k32
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_m64n128k16(d, da, db);
}
__device__ __forceinline__ void wgmma_step(int (&d)[64], uint64_t da, uint64_t db) {
  wgmma_s8<128>(d, da, db);
}

// the score tile's column of column n of query q (a permutation within
// each 32 columns)
__device__ __forceinline__ int score_col(int q, int n) { return n ^ (8 * (q & 3)); }

// Offer query j's row of a score tile (rows row0 .. row0 + 127; those
// before `end`) to its sorted list lv/li of length k; gs: the lane's rows'
// s8 scales (1 in bf16 and past count). The lane's four scores (rows
// 32u + lane) are filtered at once against the list's k-th entry, so a
// tile with no winner, the common case once the list has filled, costs
// six loads and one vote. At k = 1 the winners go to warp_offer, 32 rows
// at a time in ascending order; at k > 1 to the query's buffer bv/bi,
// holding *cnt, which is merged into the list in one step when full
// (warp_append, warp_flush: the list becomes the top k of both, whatever
// the order they came in), and once more after the last tile. The rare
// path stays a rolled loop: the selection warps' code is kept small.
__device__ __forceinline__ void offer_tile(float* lv, int* li, float* bv, int* bi, int* cnt,
                                           int k, const float* sc_row, const float (&gs)[WR / 32],
                                           int j, int row0, int end, int lane) {
  float v[WR / 32];
  bool ok[WR / 32];
  const float tv = lv[k - 1];
  const int ti = li[k - 1];
  bool hit = false;
#pragma unroll
  for (int u = 0; u < WR / 32; ++u) {
    const int n = 32 * u + lane;
    v[u] = sc_row[score_col(j, n)] * gs[u];
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
// W_THREADS threads: warps 0-3 the wgmma warpgroup, 4-11 the selection
// warps, 12 the producer. gmap: the gallery's rows, boxes of WR rows x 128
// bytes. gscale and qscale (the s8 rows' and queries' f32 scales) are read
// in s8 only.
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
  constexpr int KSTAGES = P::KSTAGES, ROW = P::ROW;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  const int nst = P::nst(k);
  const uint32_t qtile = smem_u32(smem_wg);
  if (qtile & 1023) __trap();     // the swizzled operands need the alignment
  const uint32_t ring = qtile + P::Q_BYTES;
  constexpr int nsc = 2;                          // score tiles
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
      mbar_init(empty + 8 * i, W_MMA_THREADS / 32);
    }
    for (int b = 0; b < nsc; ++b) {
      mbar_init(sfull + 8 * b, W_MMA_THREADS);
      mbar_init(sempty + 8 * b, 32 * W_SEL_WARPS);
    }
    mbar_fence_init();
  }
  // the query tile, slots past the batch zero: 16-byte chunk c of row r at
  // block c / 8, chunk (c % 8) ^ (r % 8) of the row's 128 bytes there
  for (int e = threadIdx.x; e < WQ * (ROW / 16); e += W_THREADS) {
    const int r = e / (ROW / 16), c = e % (ROW / 16);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nq) v = __ldg(reinterpret_cast<const uint4*>(queries + (size_t)(q0 + r) * ROW) + c);
    *reinterpret_cast<uint4*>(smem_wg + (c >> 3) * P::Q_BLOCK + r * WKB +
                              (((c & 7) ^ (r & 7)) << 4)) = v;
  }
  fence_proxy_async();            // the tile's writes before the wgmma read it
  __syncthreads();

  if (warp == W_PRODUCER) {
    // stage g (row tile g / KSTAGES, 128 bytes of K from (g % KSTAGES) *
    // 128) into slot g % nst, once the warpgroup has freed it
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

  if (warp < W_MMA_THREADS / 32) {
    // lane l of warp w holds queries 16w + l/4 and 16w + l/4 + 8, columns
    // 8j + 2(l%4) and the next of each n8 block j of the 128
    const int qa = 16 * warp + (lane >> 2);
    float q_sc[2] = {0.f, 0.f};
    if constexpr (P::S8) {
      q_sc[0] = qa < nq ? __ldg(qscale + q0 + qa) : 0.f;
      q_sc[1] = qa + 8 < nq ? __ldg(qscale + q0 + qa + 8) : 0.f;
    }
    Acc acc[64];
    int slot = 0;
    uint32_t phase = 0;
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

      // the row tile's scores into score tile t % nsc, once the selection
      // warps are done with tile t - nsc; -1e30 past count. In s8 f32(acc)
      // * q_scale: the selection warps multiply by g_scale, each row's once
      // a warp.
      const int b = t % nsc, round = t / nsc;
      if (t >= nsc) mbar_wait(sempty + 8 * b, (round - 1) & 1);
      float* sc = scores + b * WQ * WR;
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
        *reinterpret_cast<float2*>(sc + qa * WR + score_col(qa, n)) =
            make_float2(l0 ? v[0] : NEG_INF, l1 ? v[1] : NEG_INF);
        *reinterpret_cast<float2*>(sc + (qa + 8) * WR + score_col(qa + 8, n)) =
            make_float2(l0 ? v[2] : NEG_INF, l1 ? v[3] : NEG_INF);
      }
      mbar_arrive(sfull + 8 * b);
    }
    return;
  }

  // the selection warps: warp sw keeps the lists of queries sw, sw + 8, ...
  const int sw = warp - W_MMA_THREADS / 32;
  for (int j = sw; j < nq; j += W_SEL_WARPS) {
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
    for (int j = sw; j < nq; j += W_SEL_WARPS)
      offer_tile(list_v + j * k, list_i + j * k, buf_v + 32 * j, buf_i + 32 * j, buf_n + j, k,
                 sc + j * WR, gs, j, row0, end, lane);
    mbar_arrive(sempty + 8 * b);
  }
  for (int j = sw; j < nq; j += W_SEL_WARPS) {
    if (buf_n[j])
      warp_flush(list_v + j * k, list_i + j * k, buf_v + 32 * j, buf_i + 32 * j, buf_n[j], k,
                 lane);
  }
  for (int j = sw; j < nq; j += W_SEL_WARPS) {
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
  const int err = WgTile<T>::S8 ? encode_s8_2d(map, gallery, (uint64_t)rows, D, WR)
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
  const dim3 grid((B + WQ - 1) / WQ, chunks);
  kernel<<<grid, W_THREADS, WgTile<T>::smem(k), s>>>(
      map, static_cast<const float*>(gscale), static_cast<const char*>(queries),
      static_cast<const float*>(qscale), n_rows, count, B, k, rows_per_cta,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
