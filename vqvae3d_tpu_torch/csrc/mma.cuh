// Warp-level tensor-core and copy primitives of the port's Hopper kernels
// (inline PTX, sm_80+ instructions that sm_90a keeps): mma.sync on bf16
// fragments with fp32 accumulators, ldmatrix from shared memory and cp.async
// from device memory into shared memory.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 / m16n8k8"),
// with g = lane / 4 and t = lane % 4; each 32-bit register holds two bf16,
// the lower column in the lower half:
//   A of m16n8k16 (16 x 16, row-major): a[0] = (row g, cols 2t, 2t+1),
//     a[1] = (row g+8, cols 2t, 2t+1), a[2] = (row g, cols 2t+8, 2t+9),
//     a[3] = (row g+8, cols 2t+8, 2t+9);
//   A of m16n8k8 (16 x 8): a[0], a[1] as above;
//   B of m16n8k16 (16 x 8, k x n): b[0] = (rows 2t, 2t+1, col g),
//     b[1] = (rows 2t+8, 2t+9, col g); B of m16n8k8: b[0];
//   C (16 x 8, fp32): c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] =
//     (row g+8, cols 2t, 2t+1).
// ldmatrix.x4 reads four 8 x 8 bf16 matrices whose rows (16 bytes each) lanes
// 8m .. 8m+7 address; register m of lane L receives matrix m's (row L / 4,
// cols 2 (L % 4), +1), or with .trans its (rows 2 (L % 4), +1, col L / 4).
// So a B fragment whose k runs along a row of memory (K for Q.K^T) is a
// plain ldmatrix, and one whose k runs down the rows (V for P.V) a .trans.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace vq {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a (16x16) . b (16x8), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8) . b (8x8), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// lanes 0-15 address the two matrices' rows; the other lanes' are ignored
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// (lo, hi) -> one register of two bf16, rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// 16 bytes device -> shared, the bytes past src_bytes (0 or 16) zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// 4 bytes device -> shared (no alignment beyond 4), zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace vq
