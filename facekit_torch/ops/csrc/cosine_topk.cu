// Gallery search for Hopper: scores = queries . gallery^T in f32, rows at or
// past `count` masked to -1e30, per-query top-k under the total order
// (score descending, row index ascending).
//
// Replaces: the TPU kernel `cosine_topk_pallas` -> `_search_kernel` ->
// `_fold_tile` / `_topk_rows` in facekit/ops/similarity.py:273-338 (body
// :260-270, shared fold :100-159). Same results: f32 accumulation, the
// -1e30 mask, lowest index first among equal scores, and the sentinel
// index 2**30 for empty slots, so that when k exceeds the live rows the
// masked padding rows come back in ascending order, as lax.top_k returns
// them.
//
// Bound on an H100 SXM (3.35 TB/s): the gallery is read once, N*D*itemsize
// bytes: 1,048,576 x 512 bf16 is 1.07 GB, about 0.32 ms; f32 about 0.64 ms.
// The products are 2*B*N*D operations; at B <= 8 they are far below the
// card's rate, so the kernel is bound by bytes on the main path (B <= 8).
// f32-grade products on tensor cores take three TF32 passes (495 TFLOPS
// dense), so an f32 search at B = 256 is bound by them (1.67 ms).
//
// Design of topk_partial_kernel (bf16 and f32 at B <= 8), against that
// bound:
//  * The Pallas grid runs in order on one core and carries the running
//    top-k in VMEM from step to step. Nothing carries over between CTAs
//    here, so pass 1 splits the rows across CTAs (grid.x = chunks of
//    rows, grid.y = tiles of QT queries) and every warp streams its own
//    contiguous rows. A lane reads its 16 elements of a row as 16-byte
//    loads (bf16: 2, f32: 4), neighbouring lanes on neighbouring
//    addresses, marked evict-first (the gallery is larger than L2 and is
//    read once). The loads of the next U rows are issued before the
//    arithmetic on the current ones, so a warp keeps loads in flight while
//    it computes.
//  * A warp holds its QT queries in registers (16 f32 values per query per
//    lane), so a gallery byte is read from memory once per query tile and
//    never through shared memory. QT is the smallest of 1, 2, 4, 8 that
//    covers the batch, so a batch of one does no arithmetic for empty query
//    slots. Each (row, query) dot is 16 FMAs per lane in a fixed order; the
//    partials of 32/QT rows x QT queries are then summed over the warp by
//    one transposed butterfly (31 shuffles for 32 dots, where a butterfly
//    per dot takes 5 each), unrolled so the partials stay in registers.
//    Every score is the same tree of the same instruction
//    sequence, whatever QT is, so equal rows get bit-equal scores and ties
//    resolve by index exactly.
//  * Rows past count + k are never read: rows count..count+k-1 (score
//    -1e30, ascending index) outrank every later padding row, so the scan
//    covers n_rows = min(N, count + k) and skips the loads of rows past
//    count. A mostly empty bucket costs what its live rows cost.
//  * Each warp keeps a sorted top-k per query in shared memory. The 32
//    scores of a group are filtered against their query's k-th entry
//    (kept in a register of the lanes that hold that query) with one
//    ballot. At k = 1 the scores that beat it are inserted one at a time
//    by the whole warp. At k = 64 a list over a few hundred rows takes
//    more than half of them, each a serialized insertion, and 8 queries a
//    warp made pass 1 3x as slow as at k = 1. So at k > 1 the scores that
//    also reach the CTA-wide threshold (the best k-th score any warp's
//    list of the query has published) go to a buffer of 32 per (warp,
//    query), which is sorted on shuffles and merged into the list in one
//    step when full; and the plan (similarity._search_plan) gives k > 1
//    chunks twice as long, so lists spend less of them filling.
//  * The 8 warps of a CTA merge their lists per query, the CTA writes
//    (B, chunks, k) partials, and pass 2 reduces the chunks*k candidates to
//    k under the same order: at k > 1 one CTA per query keeps only the
//    partials at or above a lower bound on the k-th score taken from the
//    chunks' first entries. That fold lives in topk_fold.cuh, shared with
//    the int8 search (cosine_topk_int8.cu).
//
// At B > 8 both types run the tensor-core pass 1 that the int8 search
// shares (topk_wgmma.cuh: the gallery by TMA, the selection on warps of its
// own, overlapped with the next row tile's products), over 128-row tiles
// with one list per query per CTA, which writes the same (B, chunks, k)
// partials: bf16 on wgmma m64n128k16 over 64 queries a CTA; f32 as 3xTF32
// (one TF32 pass alone misses the plain version's 1e-5, three keep f32's
// digits) on wgmma m64n32k8 with the gallery's rows as A and 32 queries a
// CTA as B.
//
// What it leaves for later: at B = 8 the k = 64 pass 1 still takes about
// 1.3-1.8x its k = 1 time (PERF.md).

#include <type_traits>

#include "topk_fold.cuh"
#include "topk_wgmma.cuh"

namespace {

constexpr int ELEMS = D / 32;   // elements of a row per lane

// One 16-byte load as floats: 8 bf16 (element 0 in the low half) or 4 f32.
template <bool BF16>
__device__ __forceinline__ void to_float(const uint4& u, float* o) {
  if constexpr (BF16) {
    o[0] = __uint_as_float(u.x << 16); o[1] = __uint_as_float(u.x & 0xffff0000u);
    o[2] = __uint_as_float(u.y << 16); o[3] = __uint_as_float(u.y & 0xffff0000u);
    o[4] = __uint_as_float(u.z << 16); o[5] = __uint_as_float(u.z & 0xffff0000u);
    o[6] = __uint_as_float(u.w << 16); o[7] = __uint_as_float(u.w & 0xffff0000u);
  } else {
    o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
  }
}

template <bool BF16, int QT, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 1)
topk_partial_kernel(const char* __restrict__ gallery,
                    const char* __restrict__ queries,
                    int n_rows, int count, int B, int k, int rows_per_cta,
                    float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int ESIZE = BF16 ? 2 : 4;
  constexpr int VEC = 16 / ESIZE;          // elements per 16-byte load
  constexpr int LOADS = ELEMS / VEC;       // 16-byte loads per lane per row
  constexpr int R = 32 / QT;               // rows per group
  // rows per load step: 2 KB in flight per warp at QT = 8 (registers are
  // short there: the queries take 128), 4 KB otherwise
  constexpr int U0 = (QT == 8 ? 4 : 8) / LOADS;
  constexpr int U = U0 < 1 ? 1 : (U0 > R ? R : U0);
  constexpr size_t ROW_BYTES = (size_t)D * ESIZE;
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

  // the lane's elements of each query: element t*VEC+v is column
  // t*32*VEC + lane*VEC + v, the same columns it loads of every row
  float q[QT][ELEMS];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    if (j < nq) {
      const uint4* qp = reinterpret_cast<const uint4*>(queries + (size_t)(q0 + j) * ROW_BYTES);
#pragma unroll
      for (int t = 0; t < LOADS; ++t) to_float<BF16>(qp[t * 32 + lane], &q[j][t * VEC]);
    } else {
#pragma unroll
      for (int e = 0; e < ELEMS; ++e) q[j][e] = 0.f;
    }
  }
  if constexpr (BATCHED) batches_init(lists, warp, lane);
  else lists_init(lists, warp, lane);
  int cnt[QT];                      // the batched selection's buffer fills
#pragma unroll
  for (int j = 0; j < QT; ++j) cnt[j] = 0;

  // Rows go through in groups of R: the R x QT dot partials of a group are
  // reduced over the warp by one butterfly that leaves lane l with the
  // total of (row l / QT, query l % QT).
  float thr_v = NEG_INF;            // the k-th entry of query lane % QT's list
  int thr_i = BIG_IDX;
  const int rows_per_warp = rows_per_cta / WARPS;
  const int begin = chunk * rows_per_cta + warp * rows_per_warp;
  const int end = min(begin + rows_per_warp, n_rows);
  const int live = min(end, count);
  uint4 raw[U][LOADS];
  load_rows<U, LOADS, ROW_BYTES>(raw, gallery, begin, live, lane);
  for (int base = begin; base < end; base += R) {
    float v[32];                    // v[r * QT + j]: this lane's partial
#pragma unroll
    for (int e = 0; e < 32; ++e) v[e] = 0.f;
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += U) {
      // the next U rows (the next group's first at the end of this one)
      uint4 nxt[U][LOADS];
      load_rows<U, LOADS, ROW_BYTES>(nxt, gallery, base + r0 + U, live, lane);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int t = 0; t < LOADS; ++t) {
          float x[VEC];
          to_float<BF16>(raw[u][t], x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
#pragma unroll
            for (int j = 0; j < QT; ++j)
              v[(r0 + u) * QT + j] = fmaf(x[e], q[j][t * VEC + e], v[(r0 + u) * QT + j]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int t = 0; t < LOADS; ++t) raw[u][t] = nxt[u][t];
      }
    }
    butterfly<16>(v, lane);
    const float s = base + lane / QT < count ? v[0] : NEG_INF;
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
template <bool BF16, int QT, bool BATCHED>
int launch_partial(int chunks, cudaStream_t s, const void* gallery,
                   const void* queries, int n_rows, int count, int B, int k,
                   int rows_per_cta, void* part_v, void* part_i) {
  constexpr int smem = BATCHED ? sizeof(Batches<QT>) : 0;   // dynamic
  auto kernel = topk_partial_kernel<BF16, QT, BATCHED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(chunks, (B + QT - 1) / QT);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const char*>(gallery), static_cast<const char*>(queries),
      n_rows, count, B, k, rows_per_cta,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, int QT>
int launch_partial_k(int chunks, cudaStream_t s, const void* gallery,
                     const void* queries, int n_rows, int count, int B, int k,
                     int rows_per_cta, void* part_v, void* part_i) {
  return k == 1 ? launch_partial<BF16, QT, false>(chunks, s, gallery, queries, n_rows,
                                                  count, B, k, rows_per_cta, part_v, part_i)
                : launch_partial<BF16, QT, true>(chunks, s, gallery, queries, n_rows,
                                                 count, B, k, rows_per_cta, part_v, part_i);
}

// The query tile: the smallest of 1, 2, 4, 8 that covers B.
template <bool BF16>
int launch_partial_tiled(int chunks, cudaStream_t s, const void* gallery,
                         const void* queries, int n_rows, int count, int B,
                         int k, int rows_per_cta, void* part_v, void* part_i) {
  if (B == 1)
    return launch_partial_k<BF16, 1>(chunks, s, gallery, queries, n_rows, count, B, k, rows_per_cta, part_v, part_i);
  if (B == 2)
    return launch_partial_k<BF16, 2>(chunks, s, gallery, queries, n_rows, count, B, k, rows_per_cta, part_v, part_i);
  if (B <= 4)
    return launch_partial_k<BF16, 4>(chunks, s, gallery, queries, n_rows, count, B, k, rows_per_cta, part_v, part_i);
  return launch_partial_k<BF16, 8>(chunks, s, gallery, queries, n_rows, count, B, k, rows_per_cta, part_v, part_i);
}

}  // namespace

// C entry point (loaded with ctypes). Launches both passes on `stream` and
// returns cudaGetLastError() as an int; it never synchronizes. The caller
// has checked shapes and alignment: gallery (gallery_rows >= n_rows, 512)
// and queries (B, 512) contiguous and 16-byte aligned, 1 <= k <= 64,
// B >= 1, rows_per_cta a multiple of 256 (of 128 at B > 8, which runs
// topk_partial_wgmma_kernel<uint16_t> in bf16, <float> in f32), partials
// (B, chunks, k).
extern "C" int facekit_cosine_topk(const void* gallery, const void* queries,
                                   int is_bf16, int gallery_rows, int n_rows,
                                   int count, int B, int k, int rows_per_cta,
                                   int chunks, void* part_v, void* part_i,
                                   void* out_v, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (B > 8) {
    err = is_bf16 ? launch_partial_wgmma<uint16_t>(chunks, s, gallery, gallery_rows, nullptr,
                                                   queries, nullptr, n_rows, count, B, k,
                                                   rows_per_cta, part_v, part_i)
                  : launch_partial_wgmma<float>(chunks, s, gallery, gallery_rows, nullptr,
                                                queries, nullptr, n_rows, count, B, k,
                                                rows_per_cta, part_v, part_i);
  } else if (is_bf16) {
    err = launch_partial_tiled<true>(chunks, s, gallery, queries, n_rows, count, B, k,
                                     rows_per_cta, part_v, part_i);
  } else {
    err = launch_partial_tiled<false>(chunks, s, gallery, queries, n_rows, count, B, k,
                                      rows_per_cta, part_v, part_i);
  }
  if (err != 0) return err;
  return launch_merge(s, part_v, part_i, B, chunks, k, out_v, out_i);
}
