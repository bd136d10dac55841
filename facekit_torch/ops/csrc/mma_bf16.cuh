// Warp-level tensor-core helpers for sm_90a, as inline PTX: cp.async
// copies from global to shared memory, ldmatrix, mma.sync m16n8k8 (tf32 in,
// f32 accumulators), and two splits of an f32 into two tf32 for 3xTF32.
// Used by the fused IR block (ir_block.cu: its f32 kernel on mma.sync,
// split_tf32_trunc), by the searches' wgmma pass 1 (topk_wgmma.cuh:
// split_tf32 for the f32 gallery's A fragments and its query tile,
// smem_u32) and for smem_u32 by the s8 conv (conv_s8.cu).
// Functions only, no constants, so that no name clashes with a kernel's
// own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// 16 bytes when `valid`, else none read and 16 zero bytes written (the
// src-size operand); src must still be a global address
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulators. A lane
// holds the bytes of a and b that ldmatrix.x4 (.b16) gives it for an
// m16n8k16 bf16 product (one f32 of K per register, in the same row and
// column groups); d: lane l holds rows l/4 and l/4 + 8, columns 2(l%4) and
// the next. The tensor cores read each register as f32 bits and ignore the
// low 13.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 register split as x = hi + lo exactly: hi is x rounded to 11
// significant bits (a tf32 as it stands, the low 13 bits 0), lo the rest,
// of which mma_tf32 reads the top 11 bits. Veltkamp's split: four f32
// operations on the FP32 pipe, where ptxas makes cvt.rna.tf32.f32 two
// integer operations and the INT32 pipe runs at half the rate; the splits
// compete with the mma for the warp schedulers. The _rn intrinsics keep
// them unfused.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(x);
  const float t = __fmul_rn(f, 8193.f);                 // 2^13 + 1
  const float h = __fsub_rn(t, __fsub_rn(t, f));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(f, h));
}

// The same split with hi = x's top 19 bits (x rounded toward zero to a
// tf32, what mma_tf32 reads of x) and lo = x - hi, exact in f32: one
// integer and one FP32 operation where split_tf32 takes four FP32 ones.
// lo then has up to 13 significant bits, of which mma_tf32 reads 11, so a
// product keeps about 21 bits where split_tf32's keeps 22.
__device__ __forceinline__ void split_tf32_trunc(uint32_t x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
}

}  // namespace
