// The running top-k that both gallery searches share (cosine_topk.cu and
// cosine_topk_int8.cu), as facekit's two Pallas search kernels share
// `_fold_tile` / `_topk_rows` (facekit/ops/similarity.py:100-159): the
// -1e30 mask past `count`, the order (score descending, row index
// ascending), and the sentinel index 2**30 for empty slots, so that when k
// exceeds the live rows the masked padding rows come back in ascending
// order, as lax.top_k returns them.
//
// Pass 1 (the caller's kernel) splits the rows over CTAs; each warp keeps
// a sorted top-k per query in shared memory (`Lists`), fed one group of 32
// (row, query) scores at a time (`offer_group`); the CTA merges its warps'
// lists and writes (B, chunks, k) partials (`merge_and_write`). Pass 2
// (`topk_merge_kernel`, one warp per query) reduces the chunks*k
// candidates to k under the same order.

#pragma once

#include <cuda_runtime.h>
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

// Pass 2: one warp per query reduces its chunks*k partials to k.
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

// Pass 2's launch; returns cudaGetLastError() as an int.
inline int launch_merge(cudaStream_t s, const void* part_v, const void* part_i,
                        int B, int chunks, int k, void* out_v, void* out_i) {
  topk_merge_kernel<<<(B + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      B, chunks, k, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
