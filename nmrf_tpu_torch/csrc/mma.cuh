// Tensor-core helpers of the redesigned backward kernels (K1b, K2b):
// mma.sync.m16n8k16 with bf16 operands and f32 accumulation, fed from shared
// memory by ldmatrix, quad reductions over the lanes of one C-tile row, and
// 16-byte cp.async copies into shared memory.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// lane = 4 g + t:
//   A 16x16: a0 (row g, cols 2t, 2t+1), a1 (row g+8, the same cols),
//            a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B 16x8:  b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, the same).
// Two adjacent C tiles of one product are one A fragment of the next
// (FlashAttention-2 keeps P and dS in registers that way).
// Shared-memory rows passed to the loaders start on 16-byte boundaries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nmrf {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of rows m0..m0+15, cols k0..k0+15 of a row-major [rows, ld] tile
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* base, int ld, int m0,
                                       int k0, int lane) {
  ldsm_x4(a, base + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// A fragment of the transpose: A[m][k] = M[k][m] of a row-major M [.., ld],
// rows m0..m0+15 of A (cols of M), cols k0..k0+15 of A (rows of M)
__device__ __forceinline__ void load_a_trans(uint32_t a[4], const __nv_bfloat16* base, int ld,
                                             int m0, int k0, int lane) {
  ldsm_x4_trans(a, base + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                       ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles (n0..n0+7 in b[0..1], n0+8..n0+15 in b[2..3])
// at k0..k0+15, with B[k][n] = M[n][k] of a row-major M [.., ld] (B = M^T:
// the rows of M are the columns of B, e.g. K in S = Q K^T)
__device__ __forceinline__ void load_b_rows(uint32_t b[4], const __nv_bfloat16* base, int ld,
                                            int n0, int k0, int lane) {
  ldsm_x4(b, base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles at k0..k0+15 with B[k][n] = M[k][n] of a
// row-major M [.., ld] (e.g. V in O = P V)
__device__ __forceinline__ void load_b_cols(uint32_t b[4], const __nv_bfloat16* base, int ld,
                                            int k0, int n0, int lane) {
  ldsm_x4_trans(b, base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// c += a b (16x8x16, bf16 operands, f32 accumulators)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment (16 rows, 16 cols) of two adjacent C tiles c0 | c1
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// sum and max over the 4 lanes of a quad (the lanes that hold one row of a
// C tile)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (then
// nothing is read, but src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace nmrf
