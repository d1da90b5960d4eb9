// bf16 tensor-core helpers shared by the fused MLP (B8/B9,
// fused_mlp_cm.cu) and the fused shading head (B3/B4, fused_shade_cm.cu):
// the mma.sync m16n8k16 product (bf16 in, fp32 accumulate), bf16 packing,
// ldmatrix fragment loads from shared memory, and cp.async copies.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                     a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9]
//   B (16 x 8, col):  b0 = B[2t..2t+1][g],   b1 = B[2t+8..+9][g]
//   C (16 x 8):       c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
//
// ldmatrix reads 8 x 8 bf16 blocks whose 8 rows of 16 bytes are given by
// 8 lanes each; a row stride whose count of 16-byte chunks is odd puts
// the 8 rows on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}

// A fragment at (m0, k0) of a product whose A is stored in shared memory
// as rows [m][k] (stride sa elements): four blocks (m, k), (m+8, k),
// (m, k+8), (m+8, k+8).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* S,
                                       int sa, int m0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldsm_x4(a, S + (m0 + (q & 1) * 8 + r) * sa + k0 + (q >> 1) * 8);
}

// A fragment at (m0, k0) where A is stored transposed, rows [k][m].
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4],
                                         const __nv_bfloat16* S, int sa,
                                         int m0, int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldsm_x4_t(a, S + (k0 + (q >> 1) * 8 + r) * sa + m0 + (q & 1) * 8);
}

// B fragment (b0, b1) at (k0, n0) where B is stored as rows [n][k].
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const __nv_bfloat16* S, int sb, int n0,
                                       int k0, int lane) {
  const int q = (lane >> 3) & 1, r = lane & 7;
  ldsm_x2(b0, b1, S + (n0 + r) * sb + k0 + q * 8);
}

// B fragment (b0, b1) at (k0, n0) where B is stored as rows [k][n].
__device__ __forceinline__ void frag_b_t(uint32_t& b0, uint32_t& b1,
                                         const __nv_bfloat16* S, int sb,
                                         int n0, int k0, int lane) {
  const int q = (lane >> 3) & 1, r = lane & 7;
  ldsm_x2_t(b0, b1, S + (k0 + q * 8 + r) * sb + n0);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `n` of this thread's groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}
