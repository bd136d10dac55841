// The running top-k that both gallery searches share (cosine_topk.cu and
// cosine_topk_int8.cu), as facekit's two Pallas search kernels share
// `_fold_tile` / `_topk_rows` (facekit/ops/similarity.py:100-159): the
// -1e30 mask past `count`, the order (score descending, row index
// ascending), and the sentinel index 2**30 for empty slots, so that when k
// exceeds the live rows the masked padding rows come back in ascending
// order, as lax.top_k returns them.
//
// Pass 1 at B <= 8 (the caller's CUDA-core kernel) splits the rows over
// CTAs; each warp keeps a sorted top-k per query in shared memory, fed one
// group of 32 (row, query) scores at a time, and the CTA merges its warps'
// lists and writes (B, chunks, k) partials. At k = 1 a score that beats
// the list's k-th entry is inserted at once (`Lists`, `offer_group`,
// `merge_and_write`); at k > 1 the scores that pass a per-list and a
// CTA-wide threshold are buffered and merged 32 at a time (`Batches`,
// `offer_group_batched`, `merge_and_write_batched`). Pass 2 reduces each
// query's chunks*k partials to k under the same order: at k = 1 one warp
// per query (`topk_merge_kernel`), at k > 1 one CTA per query that prunes
// below a bound taken from the chunks' sorted lists
// (`topk_prune_merge_kernel`). Both serve the tensor-core pass 1 of
// topk_wgmma.cuh (B > 8, every type) too, whose selection warps use
// `warp_offer`, `warp_append` and `warp_flush`.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 512;          // embedding width (the wrappers check it)
constexpr int KMAX = 64;        // largest k (the wrappers check it)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr int BIG_IDX = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool beats(float v, int i, float tv, int ti) {
  return v > tv || (v == tv && i < ti);
}

// The transposed butterfly over a warp: lane l starts with 32 partial
// sums and ends with the warp's total of sum l in v[0]. Each step halves
// the values a lane holds: the lane keeps the half whose index bit matches
// its lane bit HALF and adds the partner lane's copy of that half. Every
// total is the same tree over the lanes' partials (addition commutes), so
// equal rows get bit-equal scores. HALF is a template argument so that
// each loop's trip count is a constant when the compiler unrolls it; a
// loop nest whose inner count depends on the outer index stays rolled and
// puts v in local memory.
template <int HALF, typename T>
__device__ __forceinline__ void butterfly(T (&v)[32], int lane) {
  const bool hi = lane & HALF;
#pragma unroll
  for (int e = 0; e < HALF; ++e) {
    const T keep = hi ? v[e + HALF] : v[e];
    const T send = hi ? v[e] : v[e + HALF];
    v[e] = keep + __shfl_xor_sync(FULL, send, HALF);
  }
  if constexpr (HALF > 1) butterfly<HALF / 2>(v, lane);
}

// The lane's 16-byte pieces of rows first..first+U-1; zeros for rows at or
// past `live` (padding rows and rows of the next warp are not read).
template <int U, int LOADS, size_t ROW_BYTES>
__device__ __forceinline__ void load_rows(uint4 (&buf)[U][LOADS],
                                          const char* __restrict__ gallery,
                                          int first, int live, int lane) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int row = first + u;
    if (row < live) {
      const uint4* gp = reinterpret_cast<const uint4*>(gallery + (size_t)row * ROW_BYTES);
#pragma unroll
      for (int t = 0; t < LOADS; ++t) buf[u][t] = __ldcs(gp + t * 32 + lane);
    } else {
#pragma unroll
      for (int t = 0; t < LOADS; ++t) buf[u][t] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Insert (v, i) into a warp's sorted list lv/li of length k. The caller
// has checked that (v, i) beats lv[k-1]; all lanes pass the same (v, i).
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k,
                                            float v, int i, int lane) {
  const int e0 = lane, e1 = lane + 32;
  float v0 = NEG_INF, v1 = NEG_INF;
  int i0 = BIG_IDX, i1 = BIG_IDX;
  if (e0 < k) { v0 = lv[e0]; i0 = li[e0]; }
  if (e1 < k) { v1 = lv[e1]; i1 = li[e1]; }
  const bool b0 = e0 < k && beats(v0, i0, v, i);
  const bool b1 = e1 < k && beats(v1, i1, v, i);
  // the list is sorted, so the entries that beat (v, i) are a prefix
  const int pos = __popc(__ballot_sync(FULL, b0)) + __popc(__ballot_sync(FULL, b1));
  __syncwarp();
  if (e0 >= pos && e0 + 1 < k) { lv[e0 + 1] = v0; li[e0 + 1] = i0; }
  if (e1 >= pos && e1 + 1 < k) { lv[e1 + 1] = v1; li[e1 + 1] = i1; }
  if (lane == 0) { lv[pos] = v; li[pos] = i; }
  __syncwarp();
}

// Offer 32 lane-held candidates (v, i) to a warp's list; `ok` marks the
// lanes that hold one.
__device__ __forceinline__ void warp_offer(float* lv, int* li, int k,
                                           float v, int i, bool ok, int lane) {
  unsigned m = __ballot_sync(FULL, ok && beats(v, i, lv[k - 1], li[k - 1]));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(FULL, v, src);
    const int ci = __shfl_sync(FULL, i, src);
    if (beats(cv, ci, lv[k - 1], li[k - 1])) warp_insert(lv, li, k, cv, ci, lane);
  }
}

// Every warp's sorted top-k of each of the CTA's QT queries.
template <int QT>
struct Lists {
  float v[WARPS][QT][KMAX];
  int i[WARPS][QT][KMAX];
};

template <int QT>
__device__ __forceinline__ void lists_init(Lists<QT>& L, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    for (int s = lane; s < KMAX; s += 32) {
      L.v[warp][j][s] = NEG_INF;
      L.i[warp][j][s] = BIG_IDX;
    }
  }
  __syncwarp();
}

// Offer one group's 32 scores: lane l holds the score `s` of row
// base + l / QT for query l % QT (the layout the butterfly leaves). Rows
// at or past `end` belong to no one; queries at or past `nq` are empty
// slots. (thr_v, thr_i) is the k-th entry of the lane's query's list.
template <int QT>
__device__ __forceinline__ void offer_group(Lists<QT>& L, int warp, int lane,
                                            float s, int base, int end, int nq,
                                            int k, float& thr_v, int& thr_i) {
  const int my_j = lane % QT;
  const int row = base + lane / QT;
  unsigned m = __ballot_sync(
      FULL, row < end && my_j < nq && beats(s, row, thr_v, thr_i));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(FULL, s, src);
    const int ci = base + src / QT;
    const int cj = src % QT;
    float* lv = L.v[warp][cj];
    int* li = L.i[warp][cj];
    if (beats(cv, ci, lv[k - 1], li[k - 1])) {
      warp_insert(lv, li, k, cv, ci, lane);
      if (my_j == cj) { thr_v = lv[k - 1]; thr_i = li[k - 1]; }
    }
  }
}

// Merge the warps' lists (warp j folds query j's eight lists into warp
// 0's) and write the CTA's partial top-k of each query.
template <int QT>
__device__ __forceinline__ void merge_and_write(Lists<QT>& L, int warp, int lane,
                                                int nq, int q0, int chunk,
                                                int chunks, int k,
                                                float* __restrict__ part_v,
                                                int* __restrict__ part_i) {
  __syncthreads();
  if (warp < nq) {
    const int j = warp;
    float* lv = L.v[0][j];
    int* li = L.i[0][j];
    for (int w = 1; w < WARPS; ++w) {
      for (int s0 = 0; s0 < k; s0 += 32) {
        const int s = s0 + lane;
        const bool ok = s < k;
        const float v = ok ? L.v[w][j][s] : NEG_INF;
        const int i = ok ? L.i[w][j][s] : BIG_IDX;
        warp_offer(lv, li, k, v, i, ok, lane);
      }
    }
    const size_t off = ((size_t)(q0 + j) * chunks + chunk) * k;
    for (int s = lane; s < k; s += 32) {
      part_v[off + s] = lv[s];
      part_i[off + s] = li[s];
    }
  }
}

// ---- The batched selection of pass 1 at k > 1 -----------------------------
//
// Offering a score to a sorted list one at a time costs two ballots and two
// __syncwarp, and at k = 64 a warp's list over a few hundred rows takes
// more than half its rows. So at k > 1 the scores that pass the filter are
// appended to a buffer of 32 per (warp, query), and a full buffer is merged
// into the list in one step (`warp_flush`: a bitonic sort of the 32 on
// shuffles, then each entry's place in the merged order by binary search),
// the scheme of WarpSelect (Johnson, Douze and Jegou, "Billion-scale
// similarity search with GPUs", 2017). The filter is the list's k-th entry
// (as of the last flush) and, CTA-wide, the largest k-th score that any
// warp's list of that query has published: k rows of that warp score at
// least as much, so a score strictly below it cannot reach the CTA's top k.
// Scores equal to it pass, so ties still resolve by index.

// A float as an int with the same order, for atomicMax.
__device__ __forceinline__ int ordered(float f) {
  const int x = __float_as_int(f);
  return x >= 0 ? x : x ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int x) {
  return __int_as_float(x >= 0 ? x : x ^ 0x7fffffff);
}

// The lanes that hold query j in offer_group's layout (lane % QT == j).
template <int QT>
__device__ __forceinline__ unsigned query_lanes(int j) {
  constexpr unsigned base = QT == 1 ? FULL : QT == 2 ? 0x55555555u
                          : QT == 4 ? 0x11111111u : 0x01010101u;
  return base << j;
}

// Sort the warp's 32 (v, i), one per lane, descending under `beats`: a
// bitonic network on shuffles; lane l ends with the entry of rank l.
__device__ __forceinline__ void warp_sort32(float& v, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, stride);
      const int oi = __shfl_xor_sync(FULL, i, stride);
      // the lower lane of a pair keeps the better entry in a descending
      // block, the worse in an ascending one
      const bool keep_better = ((lane & stride) == 0) == ((lane & size) == 0);
      if (beats(ov, oi, v, i) == keep_better) { v = ov; i = oi; }
    }
  }
}

// Merge the n (<= 32) entries of a warp's buffer bv/bi, in any order, into
// its sorted list lv/li of length k: the list becomes the top k of both.
// An entry's place is its rank in its own sorted run plus the entries of
// the other run ahead of it (the list's first among equals), so every
// place below k is written once; all reads precede all writes.
__device__ __forceinline__ void warp_flush(float* lv, int* li, float* bv, int* bi,
                                           int n, int k, int lane) {
  float v = lane < n ? bv[lane] : -INFINITY;
  int i = lane < n ? bi[lane] : INT_MAX;
  warp_sort32(v, i, lane);
  bv[lane] = v;
  bi[lane] = i;
  __syncwarp();
  // the buffer entry's place: its rank, plus the list entries that beat
  // or equal it (a prefix of the list)
  int at = 0;
#pragma unroll
  for (int step = 64; step > 0; step >>= 1)
    if (at + step <= k && !beats(v, i, lv[at + step - 1], li[at + step - 1])) at += step;
  const int rb = lane + at;
  // the list entries' places: their rank, plus the buffer entries that
  // beat them (a prefix of the sorted buffer)
  const int p0 = lane, p1 = lane + 32;
  float a0 = 0.f, a1 = 0.f;
  int ai0 = 0, ai1 = 0, r0 = k, r1 = k;
  if (p0 < k) {
    a0 = lv[p0]; ai0 = li[p0];
    int c = 0;
#pragma unroll
    for (int step = 32; step > 0; step >>= 1)
      if (c + step <= 32 && beats(bv[c + step - 1], bi[c + step - 1], a0, ai0)) c += step;
    r0 = p0 + c;
  }
  if (p1 < k) {
    a1 = lv[p1]; ai1 = li[p1];
    int c = 0;
#pragma unroll
    for (int step = 32; step > 0; step >>= 1)
      if (c + step <= 32 && beats(bv[c + step - 1], bi[c + step - 1], a1, ai1)) c += step;
    r1 = p1 + c;
  }
  __syncwarp();
  if (rb < k) { lv[rb] = v; li[rb] = i; }
  if (r0 < k) { lv[r0] = a0; li[r0] = ai0; }
  if (r1 < k) { lv[r1] = a1; li[r1] = ai1; }
  __syncwarp();
}

// Append the lanes' candidates marked `ok` to a warp's buffer, which holds
// `cnt` (warp-uniform) entries, flushing it into the list first when they
// would not fit. Returns whether it flushed.
__device__ __forceinline__ bool warp_append(float* lv, int* li, float* bv, int* bi,
                                            int& cnt, int k, float v, int i,
                                            bool ok, unsigned m, int lane) {
  const int n = __popc(m);
  bool flushed = false;
  if (cnt + n > 32) {
    warp_flush(lv, li, bv, bi, cnt, k, lane);
    cnt = 0;
    flushed = true;
  }
  if (ok) {
    const int at = cnt + __popc(m & ((1u << lane) - 1u));
    bv[at] = v;
    bi[at] = i;
  }
  cnt += n;
  __syncwarp();
  return flushed;
}

// The shared memory of the batched selection: every warp's sorted top-k of
// each of the CTA's QT queries, its buffers, and per query the CTA-wide
// threshold (an `ordered` score). 49,184 bytes at QT = 8: dynamic shared
// memory.
template <int QT>
struct Batches {
  float v[WARPS][QT][KMAX];
  int i[WARPS][QT][KMAX];
  float bv[WARPS][QT][32];
  int bi[WARPS][QT][32];
  int cta[QT];
};

// The selection's shared memory: k = 1's Lists as a static array, as the
// search had it before the batched selection (so its code is unchanged),
// the Batches of k > 1 as dynamic shared memory, past the 48 KB of static.
template <typename Sel, bool DYNAMIC>
__device__ __forceinline__ Sel& selection_storage() {
  if constexpr (DYNAMIC) {
    extern __shared__ __align__(16) unsigned char sel_smem[];
    return *reinterpret_cast<Sel*>(sel_smem);
  } else {
    __shared__ Sel storage;
    return storage;
  }
}

template <int QT>
__device__ __forceinline__ void batches_init(Batches<QT>& L, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    for (int s = lane; s < KMAX; s += 32) {
      L.v[warp][j][s] = NEG_INF;
      L.i[warp][j][s] = BIG_IDX;
    }
  }
  if (threadIdx.x < QT) L.cta[threadIdx.x] = ordered(-INFINITY);
  __syncthreads();
}

// After a flush of query j's list: the lanes of query j take its new k-th
// entry as their filter, and lane 0 publishes its score CTA-wide.
template <int QT>
__device__ __forceinline__ void batches_after_flush(Batches<QT>& L, int warp, int lane,
                                                    int j, int k, float& thr_v,
                                                    int& thr_i) {
  const float* lv = L.v[warp][j];
  if (lane % QT == j) { thr_v = lv[k - 1]; thr_i = L.i[warp][j][k - 1]; }
  if (lane == 0) atomicMax(&L.cta[j], ordered(lv[k - 1]));
}

// offer_group with the batched selection; cnt[j] is the fill of query j's
// buffer (warp-uniform).
template <int QT>
__device__ __forceinline__ void offer_group_batched(Batches<QT>& L, int warp, int lane,
                                                    float s, int base, int end, int nq,
                                                    int k, float& thr_v, int& thr_i,
                                                    int (&cnt)[QT]) {
  const int my_j = lane % QT;
  const int row = base + lane / QT;
  const float cta = unordered(*reinterpret_cast<volatile int*>(&L.cta[my_j]));
  const bool ok = row < end && my_j < nq && s >= cta && beats(s, row, thr_v, thr_i);
  const unsigned m = __ballot_sync(FULL, ok);
  if (m == 0) return;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const unsigned mj = m & query_lanes<QT>(j);
    if (mj == 0) continue;
    if (warp_append(L.v[warp][j], L.i[warp][j], L.bv[warp][j], L.bi[warp][j],
                    cnt[j], k, s, row, ok && my_j == j, mj, lane))
      batches_after_flush(L, warp, lane, j, k, thr_v, thr_i);
  }
}

// Flush what the warp's buffers still hold, merge the warps' lists (warp j
// folds query j's eight lists into warp 0's, through warp 0's buffer) and
// write the CTA's partial top-k of each query.
template <int QT>
__device__ __forceinline__ void merge_and_write_batched(Batches<QT>& L, int warp, int lane,
                                                        int nq, int q0, int chunk,
                                                        int chunks, int k,
                                                        int (&cnt)[QT],
                                                        float* __restrict__ part_v,
                                                        int* __restrict__ part_i) {
#pragma unroll
  for (int j = 0; j < QT; ++j)
    if (cnt[j]) warp_flush(L.v[warp][j], L.i[warp][j], L.bv[warp][j], L.bi[warp][j],
                           cnt[j], k, lane);
  __syncthreads();
  if (warp < nq) {
    const int j = warp;
    float* lv = L.v[0][j];
    int* li = L.i[0][j];
    float* bv = L.bv[0][j];
    int* bi = L.bi[0][j];
    float tv = lv[k - 1];
    int ti = li[k - 1];
    int c = 0;
    for (int w = 1; w < WARPS; ++w) {
      for (int s0 = 0; s0 < k; s0 += 32) {
        const int s = s0 + lane;
        const bool in = s < k;
        const float v = in ? L.v[w][j][s] : NEG_INF;
        const int i = in ? L.i[w][j][s] : BIG_IDX;
        const bool ok = in && beats(v, i, tv, ti);
        const unsigned m = __ballot_sync(FULL, ok);
        if (warp_append(lv, li, bv, bi, c, k, v, i, ok, m, lane)) {
          tv = lv[k - 1];
          ti = li[k - 1];
        }
        // list w is sorted: past its first entry that fails, all fail
        if (m != FULL) break;
      }
    }
    if (c) warp_flush(lv, li, bv, bi, c, k, lane);
    const size_t off = ((size_t)(q0 + j) * chunks + chunk) * k;
    for (int s = lane; s < k; s += 32) {
      part_v[off + s] = lv[s];
      part_i[off + s] = li[s];
    }
  }
}

// Pass 2 at k = 1: one warp per query reduces its chunks partials to 1.
__global__ void __launch_bounds__(THREADS)
topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int B, int chunks, int k,
                  float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float s_v[WARPS][KMAX];
  __shared__ int s_i[WARPS][KMAX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;                      // whole warps only
  float* lv = s_v[warp];
  int* li = s_i[warp];
  for (int s = lane; s < KMAX; s += 32) { lv[s] = NEG_INF; li[s] = BIG_IDX; }
  __syncwarp();
  const size_t total = (size_t)chunks * k;
  const float* pv = part_v + (size_t)b * total;
  const int* pi = part_i + (size_t)b * total;
  for (size_t base = 0; base < total; base += 32) {
    const size_t t = base + lane;
    const bool ok = t < total;
    const float v = ok ? pv[t] : NEG_INF;
    const int i = ok ? pi[t] : BIG_IDX;
    warp_offer(lv, li, k, v, i, ok, lane);
  }
  for (int s = lane; s < k; s += 32) {
    out_v[(size_t)b * k + s] = lv[s];
    out_i[(size_t)b * k + s] = li[s];
  }
}

// ---- Pass 2 at k > 1 -----------------------------------------------------
//
// A query has chunks*k partials (32,768 at B <= 8 and k = 64 over a
// million rows), which one warp would scan in one dependent step per 32.
// Each chunk's list is sorted, so the k-th best of any k of its entries
// from different rows bounds the query's k-th score from below, and only
// entries at or above it can be in the top k. The CTA of a query takes the
// first ceil(k / chunks) entries of every chunk, sorts them (a bitonic
// network over the CTA) and takes the k-th as the bound; every chunk whose
// first entry reaches it gives its prefix at or above it, one warp per
// chunk, into shared memory; a sort of those gives the k. On random rows
// the bound sits near the k-th score and a few hundred entries survive.
// Entries equal to the bound are kept, so ties resolve by index as before;
// an empty slot (-1e30, 2**30) counts as a row only at -1e30, where the
// bound prunes nothing. Where more survive than shared memory holds
// (thousands of equal scores), one warp scans every entry at or above the
// bound with the insertions of pass 1.

constexpr int MCAP = 2048;         // entries pass 2 holds in shared memory

// Sort s_v/s_i[0, n) descending under `beats`, n a power of two: a
// bitonic network over the CTA. The caller has synchronized the writes.
__device__ __forceinline__ void block_sort(float* s_v, int* s_i, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const float av = s_v[lo], bv = s_v[hi];
        const int ai = s_i[lo], bi = s_i[hi];
        // blocks of `size` alternate direction; the last is descending
        const bool swap = (lo & size) == 0 ? beats(bv, bi, av, ai)
                                           : beats(av, ai, bv, bi);
        if (swap) {
          s_v[lo] = bv; s_v[hi] = av;
          s_i[lo] = bi; s_i[hi] = ai;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Pass 2 at k > 1: one CTA per query.
__global__ void __launch_bounds__(THREADS)
topk_prune_merge_kernel(const float* __restrict__ part_v,
                        const int* __restrict__ part_i, int chunks, int k,
                        float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float s_v[MCAP];
  __shared__ int s_i[MCAP];
  __shared__ int s_act[MCAP];
  __shared__ int s_n, s_nact;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const size_t total = (size_t)chunks * k;
  const float* pv = part_v + (size_t)b * total;
  const int* pi = part_i + (size_t)b * total;

  // the bound: the k-th best of the first m entries of every chunk
  const int m = (k + chunks - 1) / chunks;
  const bool fits = chunks * m <= MCAP;
  float bound = -INFINITY;
  if (fits) {
    const int p = pow2_at_least(chunks * m);
    for (int t = threadIdx.x; t < p; t += THREADS) {
      s_v[t] = t < chunks * m ? pv[(size_t)(t / m) * k + t % m] : -INFINITY;
      s_i[t] = t;
    }
    __syncthreads();
    block_sort(s_v, s_i, p);
    bound = s_v[k - 1];
  }
  if (threadIdx.x == 0) { s_n = 0; s_nact = 0; }
  __syncthreads();
  // the chunks that can give an entry at or above the bound
  if (fits) {
    for (int c = threadIdx.x; c < chunks; c += THREADS)
      if (pv[(size_t)c * k] >= bound) s_act[atomicAdd(&s_nact, 1)] = c;
  }
  __syncthreads();
  const int nact = fits ? s_nact : 0;
  // each active chunk's prefix at or above the bound, into s_v/s_i
  for (int a = warp; a < nact; a += WARPS) {
    const size_t off = (size_t)s_act[a] * k;
    for (int s0 = 0; s0 < k; s0 += 32) {
      const int s = s0 + lane;
      const float v = s < k ? pv[off + s] : -INFINITY;
      const bool ok = s < k && v >= bound;
      const unsigned mk = __ballot_sync(FULL, ok);
      int at = 0;
      if (lane == 0) at = atomicAdd(&s_n, __popc(mk));
      at = __shfl_sync(FULL, at, 0) + __popc(mk & ((1u << lane) - 1u));
      if (ok && at < MCAP) { s_v[at] = v; s_i[at] = pi[off + s]; }
      if (mk != FULL) break;     // the list is sorted: the rest fall below
    }
  }
  __syncthreads();
  const int n = s_n;
  if (fits && n <= MCAP) {
    // n >= k: the k entries that set the bound survive
    const int p = pow2_at_least(n);
    for (int t = n + threadIdx.x; t < p; t += THREADS) {
      s_v[t] = -INFINITY;
      s_i[t] = INT_MAX;
    }
    __syncthreads();
    block_sort(s_v, s_i, p);
    for (int s = threadIdx.x; s < k; s += THREADS) {
      out_v[(size_t)b * k + s] = s_v[s];
      out_i[(size_t)b * k + s] = s_i[s];
    }
  } else if (warp == 0) {
    float* lv = s_v;
    int* li = s_i;
    for (int s = lane; s < KMAX; s += 32) { lv[s] = NEG_INF; li[s] = BIG_IDX; }
    __syncwarp();
    for (size_t base = 0; base < total; base += 32) {
      const size_t t = base + lane;
      const bool in = t < total;
      const float v = in ? pv[t] : NEG_INF;
      const int i = in ? pi[t] : BIG_IDX;
      warp_offer(lv, li, k, v, i, in && v >= bound, lane);
    }
    for (int s = lane; s < k; s += 32) {
      out_v[(size_t)b * k + s] = lv[s];
      out_i[(size_t)b * k + s] = li[s];
    }
  }
}

// Pass 2's launch; returns cudaGetLastError() as an int.
inline int launch_merge(cudaStream_t s, const void* part_v, const void* part_i,
                        int B, int chunks, int k, void* out_v, void* out_i) {
  if (k == 1) {
    topk_merge_kernel<<<(B + WARPS - 1) / WARPS, THREADS, 0, s>>>(
        static_cast<const float*>(part_v), static_cast<const int*>(part_i),
        B, chunks, k, static_cast<float*>(out_v), static_cast<int*>(out_i));
  } else {
    topk_prune_merge_kernel<<<B, THREADS, 0, s>>>(
        static_cast<const float*>(part_v), static_cast<const int*>(part_i),
        chunks, k, static_cast<float*>(out_v), static_cast<int*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
