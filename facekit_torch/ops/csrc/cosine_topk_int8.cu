// int8 gallery search for Hopper: s8 queries (quantized per row by the
// wrapper) . s8 gallery^T summed in int32, score = (f32(acc) * q_scale) *
// g_scale, rows at or past `count` masked to -1e30, per-query top-k under
// the total order (score descending, row index ascending).
//
// Replaces: the TPU kernel `cosine_topk_int8_pallas` ->
// `_search_kernel_int8` -> `_fold_tile` in facekit/ops/similarity.py:
// 181-257 (body :162-178, shared fold :127-159). Same results, bit for
// bit: the s8 dot over D = 512 is an integer with |acc| <= 127^2 * 512 <
// 2^24, so f32(acc) is exact and the score is the same two f32 multiplies
// in the same order as `similarity.py:90` and `:176`; the mask, tie order
// and 2**30 sentinel are the fold of topk_fold.cuh, shared with the
// bf16/f32 search (cosine_topk.cu).
//
// Bound on an H100 SXM (3.35 TB/s): only the rows the search needs are
// read, n_rows * (512 + 4) bytes with n_rows = min(N, count + k): at
// N = 1,048,576 that is 0.541 GB, about 0.162 ms. The 2*B*n_rows*512
// operations take 0.035 ms at B = 64 at the int8 tensor-core rate (1,979
// TOPS), so the search is bound by bytes up to B of about 300.
//
// B <= 8 (topk_int8_partial_kernel): the two-pass structure of
// cosine_topk.cu's CUDA-core kernel, with the dot in integers.
//  * A lane's share of a row is 16 bytes: one 16-byte load (evict-first),
//    neighbouring lanes on neighbouring addresses, a warp reads a row in
//    one 512-byte transaction. The loads of the next U rows are issued
//    before the arithmetic on the current ones.
//  * A warp holds its QT queries in registers (4 words of 4 s8 per query
//    per lane). Each (row, query) partial is 4 __dp4a; the partials of
//    32/QT rows x QT queries are summed over the warp by one transposed
//    butterfly in int32, where the order of the sum does not matter.
//  * The lane that ends with (row, query) loads that row's f32 scale (the
//    scales are read once per row, beside the row) and forms the score.
//  * Rows past count + k are never read (see cosine_topk.cu).
//  * The selection is cosine_topk.cu's: at k = 1 each winning score is
//    inserted at once, at k > 1 the batched selection of topk_fold.cuh
//    (a buffer of 32 per warp and query merged in one step, a CTA-wide
//    threshold) over chunks twice as long, and pass 2 prunes below a bound.
//
// B > 8 runs the tensor-core pass 1 that the bf16 search shares,
// topk_partial_wgmma_kernel<int8_t> in topk_wgmma.cuh: wgmma m64n128k32
// s8 with s32 accumulators over a 64-query tile in shared memory, so the
// rows leave HBM about once, not once per 8 queries, fed by TMA loads of
// the gallery into a ring of stages; the epilogue forms the same score,
// (f32(acc) * q_scale) * g_scale, and selection warps of their own offer
// it to one list per query per CTA while the next tile's products run.
// Both write (B, chunks, k) partials for the one pass 2.
//
// What it leaves for later: at B = 8 the k = 64 pass 1 still takes about
// 2x its k = 1 time (PERF.md).

#include <type_traits>

#include "topk_fold.cuh"
#include "topk_wgmma.cuh"

namespace {

template <int QT, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 1)
topk_int8_partial_kernel(const char* __restrict__ gallery,
                         const float* __restrict__ gscale,
                         const char* __restrict__ queries,
                         const float* __restrict__ qscale,
                         int n_rows, int count, int B, int k, int rows_per_cta,
                         float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int R = 32 / QT;               // rows per group
  constexpr int U = R < 8 ? R : 8;         // rows per load step (4 KB per warp)
  static_assert(R * QT == 32 && R % U == 0, "a group is 32 (row, query) dots");

  // k = 1 keeps a list per warp and query (topk_fold.cuh Lists); k > 1
  // the batched selection (Batches)
  using Sel = std::conditional_t<BATCHED, Batches<QT>, Lists<QT>>;
  Sel& lists = selection_storage<Sel, BATCHED>();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, B - q0);
  const int chunk = blockIdx.x;
  const int chunks = gridDim.x;

  // the lane's 16 bytes of each query: columns lane*16 .. lane*16+15, the
  // same columns it loads of every row
  int q[QT][4];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (j < nq) u = reinterpret_cast<const uint4*>(queries + (size_t)(q0 + j) * D)[lane];
    q[j][0] = (int)u.x; q[j][1] = (int)u.y; q[j][2] = (int)u.z; q[j][3] = (int)u.w;
  }
  if constexpr (BATCHED) batches_init(lists, warp, lane);
  else lists_init(lists, warp, lane);
  int cnt[QT];                      // the batched selection's buffer fills
#pragma unroll
  for (int j = 0; j < QT; ++j) cnt[j] = 0;

  // the scale of the query this lane scores (see offer_group's layout)
  const int my_j = lane % QT;
  const float qs = my_j < nq ? qscale[q0 + my_j] : 0.f;
  float thr_v = NEG_INF;            // the k-th entry of query my_j's list
  int thr_i = BIG_IDX;
  const int rows_per_warp = rows_per_cta / WARPS;
  const int begin = chunk * rows_per_cta + warp * rows_per_warp;
  const int end = min(begin + rows_per_warp, n_rows);
  const int live = min(end, count);
  uint4 raw[U][1];
  load_rows<U, 1, D>(raw, gallery, begin, live, lane);
  for (int base = begin; base < end; base += R) {
    int v[32];                      // v[r * QT + j]: this lane's partial
#pragma unroll
    for (int e = 0; e < 32; ++e) v[e] = 0;
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += U) {
      uint4 nxt[U][1];
      load_rows<U, 1, D>(nxt, gallery, base + r0 + U, live, lane);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint4 x = raw[u][0];
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          int a = v[(r0 + u) * QT + j];
          a = __dp4a((int)x.x, q[j][0], a);
          a = __dp4a((int)x.y, q[j][1], a);
          a = __dp4a((int)x.z, q[j][2], a);
          a = __dp4a((int)x.w, q[j][3], a);
          v[(r0 + u) * QT + j] = a;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) raw[u][0] = nxt[u][0];
    }
    butterfly<16>(v, lane);
    const int row = base + lane / QT;
    float s = NEG_INF;
    if (row < live) s = (static_cast<float>(v[0]) * qs) * gscale[row];
    if constexpr (BATCHED)
      offer_group_batched(lists, warp, lane, s, base, end, nq, k, thr_v, thr_i, cnt);
    else
      offer_group(lists, warp, lane, s, base, end, nq, k, thr_v, thr_i);
  }
  if constexpr (BATCHED)
    merge_and_write_batched(lists, warp, lane, nq, q0, chunk, chunks, k, cnt,
                            part_v, part_i);
  else
    merge_and_write(lists, warp, lane, nq, q0, chunk, chunks, k, part_v, part_i);
}

// Returns the CUDA error of setting the shared-memory size or of the
// launch, as an int.
template <int QT, bool BATCHED>
int launch_partial(int chunks, cudaStream_t s, const void* gallery,
                   const void* gscale, const void* queries, const void* qscale,
                   int n_rows, int count, int B, int k, int rows_per_cta,
                   void* part_v, void* part_i) {
  constexpr int smem = BATCHED ? sizeof(Batches<QT>) : 0;   // dynamic
  auto kernel = topk_int8_partial_kernel<QT, BATCHED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(chunks, (B + QT - 1) / QT);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const char*>(gallery), static_cast<const float*>(gscale),
      static_cast<const char*>(queries), static_cast<const float*>(qscale),
      n_rows, count, B, k, rows_per_cta,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

template <int QT>
int launch_partial_k(int chunks, cudaStream_t s, const void* gallery,
                     const void* gscale, const void* queries, const void* qscale,
                     int n_rows, int count, int B, int k, int rows_per_cta,
                     void* part_v, void* part_i) {
  return k == 1 ? launch_partial<QT, false>(chunks, s, gallery, gscale, queries, qscale,
                                            n_rows, count, B, k, rows_per_cta, part_v, part_i)
                : launch_partial<QT, true>(chunks, s, gallery, gscale, queries, qscale,
                                           n_rows, count, B, k, rows_per_cta, part_v, part_i);
}

}  // namespace

// C entry point (loaded with ctypes). Launches both passes on `stream` and
// returns the CUDA error as an int; it never synchronizes. The caller has
// checked shapes and alignment: gallery (gallery_rows >= n_rows, 512) int8
// and its (gallery_rows,) f32 scales, queries (B, 512) int8 (already
// quantized) and their (B,) f32 scales, all contiguous, the int8 arrays
// 16-byte aligned; 1 <= k <= 64, B >= 1, partials (B, chunks, k). B > 8
// runs topk_partial_wgmma_kernel<int8_t> with rows_per_cta a multiple of
// 128; B <= 8 the CUDA-core kernel with rows_per_cta a multiple of 256 and
// the query tile the smallest of 1, 2, 4, 8 that covers B.
extern "C" int facekit_cosine_topk_int8(const void* gallery, const void* gscale,
                                        const void* queries, const void* qscale,
                                        int gallery_rows, int n_rows, int count, int B,
                                        int k, int rows_per_cta, int chunks,
                                        void* part_v, void* part_i,
                                        void* out_v, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (B > 8) {
    err = launch_partial_wgmma<int8_t>(chunks, s, gallery, gallery_rows, gscale, queries,
                                       qscale, n_rows, count, B, k, rows_per_cta, part_v,
                                       part_i);
  } else if (B == 1) {
    err = launch_partial_k<1>(chunks, s, gallery, gscale, queries, qscale, n_rows, count, B, k, rows_per_cta, part_v, part_i);
  } else if (B == 2) {
    err = launch_partial_k<2>(chunks, s, gallery, gscale, queries, qscale, n_rows, count, B, k, rows_per_cta, part_v, part_i);
  } else if (B <= 4) {
    err = launch_partial_k<4>(chunks, s, gallery, gscale, queries, qscale, n_rows, count, B, k, rows_per_cta, part_v, part_i);
  } else {
    err = launch_partial_k<8>(chunks, s, gallery, gscale, queries, qscale, n_rows, count, B, k, rows_per_cta, part_v, part_i);
  }
  if (err != 0) return err;
  return launch_merge(s, part_v, part_i, B, chunks, k, out_v, out_i);
}
