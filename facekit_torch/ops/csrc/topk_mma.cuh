// The tensor-core pass 1 of the f32 search at B > 8 (cosine_topk.cu): its
// products as 3xTF32 on mma.sync m16n8k8. (bf16 and int8 run the wgmma
// kernel of topk_wgmma.cuh.)
//
// The products of a batch are 2*B*N*D operations, 2.75e11 at B = 256,
// which f32 digits need three TF32 passes of (1.67 ms at the TF32 peak),
// and the CUDA-core kernels read the gallery once per 8 queries. So a CTA
// takes one tile of MQ = 32 queries (a 64-query f32 tile would not fit in
// shared memory beside the ring; split once into a hi and a lo tile, rows
// padded by 16 bytes against ldmatrix bank conflicts; slots past the batch
// are zero) and one chunk of rows; the grid is (query tiles, chunks) with
// the query tile in blockIdx.x, so the CTAs that read the same rows run
// together and all but the first find them in L2: the gallery leaves HBM
// about once.
//  * Rows stream in stages of 128 rows x 128 bytes of K (+16 padding) with
//    cp.async.cg into a ring of MST = 3 (two stages ahead): a row tile is
//    16 stages. Rows at or past min(n_rows, count) are not read (zeros,
//    masked below).
//  * Each 32-byte K step is three m16n8k8 tf32 mma per (m16, n8) tile
//    (3xTF32): each operand x splits into hi (11 bits) and lo = x - hi
//    (split_tf32), and lo_a*hi_b, hi_a*lo_b, hi_a*hi_b go into an f32
//    accumulator in that order, which keeps about 22 bits of each product
//    where one tf32 pass keeps 11. The tensor cores round toward zero as
//    they accumulate, so one chain of 192 mma per score drifts by up to an
//    ulp of the score a step, past an f32 GEMM's error; each stage (4 k8
//    steps) sums into a fresh accumulator instead, which is then added to
//    the score's, rounded to nearest. A is the query tile, B the gallery
//    stage (a row is K-contiguous: the .col layout), both through
//    ldmatrix.x4 (a lane holds the same bytes as for m16n8k16 bf16,
//    mma_bf16.cuh). The 8 warps cover a 32 x 128 score tile, 16 x 32 each
//    (one m16 x 4 n8); warps 0-3 hold the first 16 queries, and an m16
//    tile wholly past the batch is skipped. Every score sums its K steps in
//    the same order with the same instructions (no split-K), so equal rows
//    get bit-equal scores wherever they fall.
//  * After each row tile the scores go to a 32 x 128 f32 tile in shared
//    memory, -1e30 past count. Then each warp offers them to the sorted
//    top-k of its queries (one list per query per CTA, 4 queries per warp),
//    ballot against the k-th entry first, so only the winners are
//    inserted. The CTA writes the lists as the (B, chunks, k) partials of
//    the CUDA-core kernels, which pass 2 (topk_fold.cuh) reduces.

#pragma once

#include "mma_bf16.cuh"
#include "topk_fold.cuh"

namespace {

constexpr int MR = 128;                // gallery rows per row tile
constexpr int MKB = 128;               // bytes of K per gallery stage
constexpr int MPAD = 16;               // bytes of padding per shared row
constexpr int SSTR = MR + 8;           // row stride (f32) of the score tile
static_assert(MR * MKB / 16 == 4 * THREADS, "four 16-byte pieces per thread a stage");

// The shapes of the f32 pass 1. Shared memory at 64 queries would be
// 273,408 bytes (query tile 132,096, ring 73,728, score tile 34,816, lists
// 32,768), past the 232,448 a CTA may have, so it takes MQ = 32 queries a
// CTA. Its query tile is split once into hi and lo tiles (132,096), which
// the mma read as they stand, where a warp would otherwise split its A
// fragments again at every stage; with a ring of 3 (55,296), the score
// tile (17,408) and the lists (16,384) that is 221,184 bytes.
struct MmaTile {
  static constexpr int MQ = 32;                     // queries per CTA
  static constexpr int MST = 3;                     // gallery stages in the ring
  static constexpr int ROW = D * 4;                 // bytes of a row
  static constexpr int KSTAGES = ROW / MKB;         // stages per row tile
  static constexpr int QSTR = ROW + MPAD;           // bytes per query-tile row
  static constexpr int GSTR = MKB + MPAD;           // bytes per stage row
  static constexpr uint32_t Q_BYTES = 2 * MQ * QSTR;   // hi, then lo
  static constexpr uint32_t STAGE_BYTES = MR * GSTR;
  static constexpr uint32_t S_BYTES = MQ * SSTR * 4;
  static constexpr uint32_t L_BYTES = MQ * KMAX * 4;   // the lists' scores (or indices)
  static constexpr uint32_t SMEM = Q_BYTES + MST * STAGE_BYTES + S_BYTES + 2 * L_BYTES;
};

// Grid (query tiles of MQ, chunks of rows_per_cta rows, a multiple of MR).
__global__ void __launch_bounds__(THREADS, 1)
topk_partial_mma_kernel(const char* __restrict__ gallery,
                        const char* __restrict__ queries,
                        int n_rows, int count, int B, int k, int rows_per_cta,
                        float* __restrict__ part_v, int* __restrict__ part_i) {
  using Tile = MmaTile;
  constexpr int MQ = Tile::MQ, MST = Tile::MST;
  constexpr int ROW = Tile::ROW, KSTAGES = Tile::KSTAGES;
  constexpr int QSTR = Tile::QSTR, GSTR = Tile::GSTR;
  constexpr uint32_t STAGE_BYTES = Tile::STAGE_BYTES;
  static_assert(Tile::SMEM <= 232448, "227 KB of shared memory per CTA");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                      // (MQ, QSTR) hi, then lo
  unsigned char* ring = smem + Tile::Q_BYTES;                      // MST x (MR, GSTR)
  float* sc = reinterpret_cast<float*>(ring + MST * STAGE_BYTES);  // (MQ, SSTR)
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
  for (int e = tid; e < MQ * (ROW / 16); e += THREADS) {
    const int r = e / (ROW / 16), c = (e % (ROW / 16)) * 16;
    uint4 v = zero;
    if (r < nq) v = __ldg(reinterpret_cast<const uint4*>(queries + (size_t)(q0 + r) * ROW + c));
    uint4 lo;
    split_tf32(v.x, v.x, lo.x); split_tf32(v.y, v.y, lo.y);
    split_tf32(v.z, v.z, lo.z); split_tf32(v.w, v.w, lo.w);
    *reinterpret_cast<uint4*>(qs + MQ * QSTR + r * QSTR + c) = lo;
    *reinterpret_cast<uint4*>(qs + r * QSTR + c) = v;
  }
  // warp w keeps the lists of queries w, w + WARPS, ...
  for (int j = warp; j < nq; j += WARPS) {
    for (int s = lane; s < KMAX; s += 32) {
      list_v[j * KMAX + s] = NEG_INF;
      list_i[j * KMAX + s] = BIG_IDX;
    }
  }

  // stage gs (row tile gs / KSTAGES, K bytes (gs % KSTAGES) * MKB ..) into
  // ring buffer buf: this thread copies 16 bytes of rows tid/8 + 32u
  const int ld_row = tid >> 3, ld_col = (tid & 7) * 16;
  const uint32_t ring_s = smem_u32(ring);
  auto load_stage = [&](int gs, int buf) {
    const int row0 = begin + (gs / KSTAGES) * MR;
    const int col = (gs % KSTAGES) * MKB + ld_col;
#pragma unroll
    for (int u = 0; u < MR / 32; ++u) {
      const int r = ld_row + 32 * u;
      const uint32_t off = buf * STAGE_BYTES + r * GSTR + ld_col;
      if (row0 + r < live)
        cp_async16(ring_s + off, gallery + (size_t)(row0 + r) * ROW + col);
      else
        *reinterpret_cast<uint4*>(ring + off) = zero;
    }
  };

  // warp tile: queries wm*MQ/2 .. + MQ/2 - 1 (skipped wholly past the
  // batch), rows wn*32 .. +31 of the row tile
  const int wm = warp >> 2, wn = warp & 3;
  const int wq = wm * (MQ / 2);
  const bool active = wq < nq;
  const uint32_t a_lane = smem_u32(qs) + (wq + (lane & 15)) * QSTR + (lane >> 4) * 16;
  // B: lanes 0-7 / 8-15 / 16-23 / 24-31 address n-tile 0 bytes 0-15 /
  // n-tile 0 bytes 16-31 / n-tile 1 bytes 0-15 / n-tile 1 bytes 16-31 of a
  // 32-byte K step of a pair of n8 tiles
  const uint32_t b_lane = ring_s +
      (wn * 32 + (lane & 7) + (lane >> 4) * 8) * GSTR + ((lane >> 3) & 1) * 16;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

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
    if (active) {
      const uint32_t b_st = b_lane + buf * STAGE_BYTES;
      // this stage's sums, added to acc (rounded to nearest) once the
      // stage is done; a chain of 12 mma drifts by ulps of a 32-term sum
      float part[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MKB / 32; ++kk) {
        uint32_t b[4][2], r[4];
        ldmatrix_x4(r, b_st + kk * 32);
        b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
        ldmatrix_x4(r, b_st + 16 * GSTR + kk * 32);
        b[2][0] = r[0]; b[2][1] = r[1]; b[3][0] = r[2]; b[3][1] = r[3];
        // 3xTF32: every score runs lo*hi, hi*lo, hi*hi of each k8 step
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) split_tf32(b[j][h], bh[j][h], bl[j][h]);
        uint32_t ah[4], al[4];
        ldmatrix_x4(ah, a_lane + ks * MKB + kk * 32);
        ldmatrix_x4(al, a_lane + MQ * QSTR + ks * MKB + kk * 32);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(part[j], al, bh[j][0], bh[j][1]);
          mma_tf32(part[j], ah, bl[j][0], bl[j][1]);
          mma_tf32(part[j], ah, bh[j][0], bh[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
    if (++buf == MST) buf = 0;
    if (ks < KSTAGES - 1) continue;

    // the row tile is done: lane l holds queries l/4 and l/4+8, rows 2(l%4)
    // and 2(l%4)+1 of each n8 tile; to the score tile, -1e30 past count
    const int row0 = begin + (gs / KSTAGES) * MR;
    if (active) {
      const int q = wq + (lane >> 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + (lane & 3) * 2;
        const bool l0 = row0 + n < count, l1 = row0 + n + 1 < count;
        *reinterpret_cast<float2*>(sc + q * SSTR + n) =
            make_float2(l0 ? acc[j][0] : NEG_INF, l1 ? acc[j][1] : NEG_INF);
        *reinterpret_cast<float2*>(sc + (q + 8) * SSTR + n) =
            make_float2(l0 ? acc[j][2] : NEG_INF, l1 ? acc[j][3] : NEG_INF);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
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

// The f32 pass 1 on tensor cores: grid (ceil(B / MQ), chunks). Returns
// the CUDA error of setting the shared-memory size or of the launch, as an
// int.
int launch_partial_mma(int chunks, cudaStream_t s, const void* gallery, const void* queries,
                       int n_rows, int count, int B, int k, int rows_per_cta,
                       void* part_v, void* part_i) {
  constexpr uint32_t smem = MmaTile::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int mq = MmaTile::MQ;
  const dim3 grid((B + mq - 1) / mq, chunks);
  topk_partial_mma_kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const char*>(gallery), static_cast<const char*>(queries),
      n_rows, count, B, k, rows_per_cta,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
