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
//
// Design of topk_partial_kernel (f32, and bf16 at B <= 8), against that
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
//    ballot; only scores that beat it are inserted, one at a time, by the
//    whole warp. On random data that is about k*ln(rows/k) insertions per
//    query per warp.
//  * The 8 warps of a CTA merge their lists per query, the CTA writes
//    (B, chunks, k) partials, and pass 2 (one warp per query) reduces the
//    chunks*k candidates to k under the same order. That fold lives in
//    topk_fold.cuh, shared with the int8 search (cosine_topk_int8.cu).
//
// bf16 at B > 8 (topk_partial_mma_kernel): the products of a batch are
// 2*B*N*D operations, 2.75e14 at B = 256, too many for CUDA cores, and
// the kernel above reads the gallery once per 8 queries. So a CTA takes one
// tile of 64 queries (in shared memory, rows padded by 8 bf16 against
// ldmatrix bank conflicts; slots past the batch are zero) and one chunk of
// rows; the grid is (query tiles, chunks) with the query tile in blockIdx.x,
// so the CTAs that read the same rows run together and all but the first
// find them in L2: the gallery leaves HBM about once.
//  * Rows stream in 128-row x 64-K bf16 stages (+8 padding) with cp.async.cg
//    into a ring of 4, three stages ahead; rows at or past min(n_rows,
//    count) are not read (zeros, masked below).
//  * mma.sync m16n8k16 (bf16 in, f32 accumulators; the products are exact
//    in f32, as in the plain version, only the order of the sums differs):
//    A is the query tile, B the gallery stage (a row is K-contiguous: the
//    .col layout), both through ldmatrix.x4. The 8 warps cover a 64 x 128
//    score tile, 32 x 32 each (2 m16 x 4 n8); warps 0-3 hold queries 0-31,
//    so a batch of 32 runs on every SM sub-partition, and m16 tiles wholly
//    past the batch are skipped. Every score sums its 32 k16 steps in the
//    same order, so equal rows get bit-equal scores.
//  * After each 128-row tile the scores go to a 64 x 128 f32 tile in shared
//    memory, -1e30 past count; then each warp offers them to the sorted
//    top-k of its queries (one list per query per CTA, 8 queries per warp),
//    ballot against the k-th entry first, so only the winners are inserted.
//    The CTA writes the lists as the same (B, chunks, k) partials, and pass
//    2 reduces them as above.
// What it leaves for later: wgmma/TMA, f32 at large B (tensor cores would
// mean TF32, which misses the plain version's 1e-4; 3xTF32 or a query tile
// in shared memory on CUDA cores), and k = 64 at B <= 8.

#include "mma_bf16.cuh"
#include "topk_fold.cuh"

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

template <bool BF16, int QT>
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

  __shared__ Lists<QT> lists;

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
  lists_init(lists, warp, lane);

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
    offer_group(lists, warp, lane, s, base, end, nq, k, thr_v, thr_i);
  }
  merge_and_write(lists, warp, lane, nq, q0, chunk, chunks, k, part_v, part_i);
}

template <bool BF16, int QT>
void launch_partial(int chunks, cudaStream_t s, const void* gallery,
                    const void* queries, int n_rows, int count, int B, int k,
                    int rows_per_cta, void* part_v, void* part_i) {
  const dim3 grid(chunks, (B + QT - 1) / QT);
  topk_partial_kernel<BF16, QT><<<grid, THREADS, 0, s>>>(
      static_cast<const char*>(gallery), static_cast<const char*>(queries),
      n_rows, count, B, k, rows_per_cta,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
}

// The query tile: the smallest of 1, 2, 4, 8 that covers B.
template <bool BF16>
void launch_partial_tiled(int chunks, cudaStream_t s, const void* gallery,
                          const void* queries, int n_rows, int count, int B,
                          int k, int rows_per_cta, void* part_v, void* part_i) {
  if (B == 1) {
    launch_partial<BF16, 1>(chunks, s, gallery, queries, n_rows, count, B, k, rows_per_cta, part_v, part_i);
  } else if (B == 2) {
    launch_partial<BF16, 2>(chunks, s, gallery, queries, n_rows, count, B, k, rows_per_cta, part_v, part_i);
  } else if (B <= 4) {
    launch_partial<BF16, 4>(chunks, s, gallery, queries, n_rows, count, B, k, rows_per_cta, part_v, part_i);
  } else {
    launch_partial<BF16, 8>(chunks, s, gallery, queries, n_rows, count, B, k, rows_per_cta, part_v, part_i);
  }
}

// ---- bf16 at B > 8: tensor cores -------------------------------------------

constexpr int MQ = 64;                 // queries per CTA
constexpr int MR = 128;                // gallery rows per row tile
constexpr int MK = 64;                 // K per gallery stage
constexpr int MST = 4;                 // gallery stages in the ring
constexpr int KSTAGES = D / MK;        // stages per row tile
constexpr int QSTR = D + 8;            // row stride (bf16) of the query tile
constexpr int GSTR = MK + 8;           // row stride (bf16) of a gallery stage
constexpr int SSTR = MR + 8;           // row stride (f32) of the score tile
constexpr uint32_t Q_BYTES = MQ * QSTR * 2;
constexpr uint32_t STAGE_BYTES = MR * GSTR * 2;
constexpr uint32_t S_BYTES = MQ * SSTR * 4;
constexpr uint32_t L_BYTES = MQ * KMAX * 4;   // the lists' scores (or indices)
constexpr uint32_t MMA_SMEM = Q_BYTES + MST * STAGE_BYTES + S_BYTES + 2 * L_BYTES;
static_assert(MR * MK / 8 == 4 * THREADS, "four 16-byte pieces per thread a stage");
static_assert(MMA_SMEM <= 232448, "227 KB of shared memory per CTA");

// Grid (query tiles of MQ, chunks of rows_per_cta rows, a multiple of MR).
__global__ void __launch_bounds__(THREADS, 1)
topk_partial_mma_kernel(const uint16_t* __restrict__ gallery,
                        const uint16_t* __restrict__ queries,
                        int n_rows, int count, int B, int k, int rows_per_cta,
                        float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);                // (MQ, QSTR)
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + Q_BYTES);    // MST x (MR, GSTR)
  float* sc = reinterpret_cast<float*>(smem + Q_BYTES + MST * STAGE_BYTES);  // (MQ, SSTR)
  float* list_v = sc + MQ * SSTR;                                  // (MQ, KMAX)
  int* list_i = reinterpret_cast<int*>(list_v + MQ * KMAX);        // (MQ, KMAX)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * MQ;
  const int nq = min(MQ, B - q0);
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  const int begin = chunk * rows_per_cta;
  const int end = min(begin + rows_per_cta, n_rows);
  const int live = min(end, count);
  const int total = (end - begin + MR - 1) / MR * KSTAGES;   // stages to run
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // the query tile, slots past the batch zero, 16 bytes per step
  for (int e = tid; e < MQ * (D / 8); e += THREADS) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    uint4 v = zero;
    if (r < nq) v = __ldg(reinterpret_cast<const uint4*>(queries + (size_t)(q0 + r) * D + c));
    *reinterpret_cast<uint4*>(qs + r * QSTR + c) = v;
  }
  // warp w keeps the lists of queries w, w + WARPS, ...
  for (int j = warp; j < nq; j += WARPS) {
    for (int s = lane; s < KMAX; s += 32) {
      list_v[j * KMAX + s] = NEG_INF;
      list_i[j * KMAX + s] = BIG_IDX;
    }
  }

  // stage gs (row tile gs / KSTAGES, K columns (gs % KSTAGES) * MK ..) into
  // ring buffer buf: this thread copies 16 bytes of rows tid/8 + 32u
  const int ld_row = tid >> 3, ld_col = (tid & 7) * 8;
  const uint32_t ring_s = smem_u32(ring);
  auto load_stage = [&](int gs, int buf) {
    const int row0 = begin + (gs / KSTAGES) * MR;
    const int col = (gs % KSTAGES) * MK + ld_col;
#pragma unroll
    for (int u = 0; u < MR / 32; ++u) {
      const int r = ld_row + 32 * u;
      const uint32_t off = buf * STAGE_BYTES + (r * GSTR + ld_col) * 2;
      if (row0 + r < live)
        cp_async16(ring_s + off, gallery + (size_t)(row0 + r) * D + col);
      else
        *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(ring) + off) = zero;
    }
  };

  // warp tile: queries wm*32 .. +31 (m16 tiles past the batch skipped), rows
  // wn*32 .. +31 of the row tile
  const int wm = warp >> 2, wn = warp & 3;
  const int ntile = max(0, min(2, (nq - wm * 32 + 15) / 16));
  uint32_t a_lane[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a_lane[i] = smem_u32(qs) + ((wm * 32 + i * 16 + (lane & 15)) * QSTR + (lane >> 4) * 8) * 2;
  // B: lanes 0-7 / 8-15 / 16-23 / 24-31 address n-tile 0 k 0-7 / n-tile 0
  // k 8-15 / n-tile 1 k 0-7 / n-tile 1 k 8-15 of a pair of n8 tiles
  const uint32_t b_lane = ring_s +
      ((wn * 32 + (lane & 7) + (lane >> 4) * 8) * GSTR + ((lane >> 3) & 1) * 8) * 2;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < MST - 1; ++s) {
    if (s < total) load_stage(s, s);
    cp_async_commit();
  }
  int buf = 0, ld_buf = MST - 1;
  for (int gs = 0; gs < total; ++gs) {
    cp_async_wait<MST - 2>();                    // stage gs has landed
    __syncthreads();                             // ... for every thread, and
                                                 // stage gs-1 is consumed
    if (gs + MST - 1 < total) load_stage(gs + MST - 1, ld_buf);
    cp_async_commit();
    if (++ld_buf == MST) ld_buf = 0;

    const int ks = gs % KSTAGES;
    if (ntile > 0) {
      const uint32_t b_st = b_lane + buf * STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < MK / 16; ++kk) {
        uint32_t b[4][2], r[4];
        ldmatrix_x4(r, b_st + kk * 32);
        b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
        ldmatrix_x4(r, b_st + 16 * GSTR * 2 + kk * 32);
        b[2][0] = r[0]; b[2][1] = r[1]; b[3][0] = r[2]; b[3][1] = r[3];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i < ntile) {
            uint32_t a[4];
            ldmatrix_x4(a, a_lane[i] + (ks * MK + kk * 16) * 2);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
          }
        }
      }
    }
    if (++buf == MST) buf = 0;
    if (ks < KSTAGES - 1) continue;

    // the row tile is done: lane l holds queries l/4 and l/4+8, rows 2(l%4)
    // and 2(l%4)+1 of each n8 tile; to the score tile, -1e30 past count
    const int row0 = begin + (gs / KSTAGES) * MR;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i < ntile) {
        const int q = wm * 32 + i * 16 + (lane >> 2);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn * 32 + j * 8 + (lane & 3) * 2;
          const bool l0 = row0 + n < count, l1 = row0 + n + 1 < count;
          *reinterpret_cast<float2*>(sc + q * SSTR + n) =
              make_float2(l0 ? acc[i][j][0] : NEG_INF, l1 ? acc[i][j][1] : NEG_INF);
          *reinterpret_cast<float2*>(sc + (q + 8) * SSTR + n) =
              make_float2(l0 ? acc[i][j][2] : NEG_INF, l1 ? acc[i][j][3] : NEG_INF);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        }
      }
    }
    __syncthreads();
    // each warp offers the tile's rows before `end` to its queries' lists,
    // 32 at a time; rows come in ascending order
    for (int j = warp; j < nq; j += WARPS) {
#pragma unroll
      for (int t = 0; t < MR / 32; ++t) {
        const int n = t * 32 + lane;
        warp_offer(list_v + j * KMAX, list_i + j * KMAX, k, sc[j * SSTR + n],
                   row0 + n, row0 + n < end, lane);
      }
    }
  }
  cp_async_wait<0>();

  for (int j = warp; j < nq; j += WARPS) {
    const size_t off = ((size_t)(q0 + j) * chunks + chunk) * k;
    for (int s = lane; s < k; s += 32) {
      part_v[off + s] = list_v[j * KMAX + s];
      part_i[off + s] = list_i[j * KMAX + s];
    }
  }
}

int launch_partial_mma(int chunks, cudaStream_t s, const void* gallery,
                       const void* queries, int n_rows, int count, int B, int k,
                       int rows_per_cta, void* part_v, void* part_i) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MMA_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + MQ - 1) / MQ, chunks);
  topk_partial_mma_kernel<<<grid, THREADS, MMA_SMEM, s>>>(
      static_cast<const uint16_t*>(gallery), static_cast<const uint16_t*>(queries),
      n_rows, count, B, k, rows_per_cta,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). Launches both passes on `stream` and
// returns cudaGetLastError() as an int; it never synchronizes. The caller
// has checked shapes and alignment: gallery (>= n_rows, 512) and queries
// (B, 512) contiguous and 16-byte aligned, 1 <= k <= 64, 1 <= B <= 256,
// rows_per_cta a multiple of 256 (of 128 for bf16 at B > 8, which runs
// topk_partial_mma_kernel), partials (B, chunks, k).
extern "C" int facekit_cosine_topk(const void* gallery, const void* queries,
                                   int is_bf16, int n_rows, int count, int B,
                                   int k, int rows_per_cta, int chunks,
                                   void* part_v, void* part_i,
                                   void* out_v, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && B > 8) {
    const int err = launch_partial_mma(chunks, s, gallery, queries, n_rows, count,
                                       B, k, rows_per_cta, part_v, part_i);
    if (err != 0) return err;
  } else if (is_bf16) {
    launch_partial_tiled<true>(chunks, s, gallery, queries, n_rows, count, B, k,
                               rows_per_cta, part_v, part_i);
  } else {
    launch_partial_tiled<false>(chunks, s, gallery, queries, n_rows, count, B, k,
                                rows_per_cta, part_v, part_i);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge(s, part_v, part_i, B, chunks, k, out_v, out_i);
}
