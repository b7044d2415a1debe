// Warp-level building blocks for sm_90a kernels that stage tiles with
// cp.async and multiply them with mma.sync: asynchronous global-to-shared
// copies with commit/wait groups, ldmatrix fragment loads, and the
// m16n8k16 bf16 product with f32 accumulation, and the bf16 pair packer.
// Used by paged_attention.cu, flash_prefill.cu, paged_prefill.cu and
// kv_quant.cuh.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 * gr + tq, gr in 0..7,
// tq in 0..3): A (16 x 16, row-major) a0 = A[gr][2tq..2tq+1], a1 =
// A[gr+8][2tq..], a2 = A[gr][2tq+8..], a3 = A[gr+8][2tq+8..]; B (16 x 8,
// "col") b0 = B[2tq..2tq+1][gr], b1 = B[2tq+8..2tq+9][gr]; C (16 x 8) c0,
// c1 = C[gr][2tq..2tq+1], c2, c3 = C[gr+8][2tq..2tq+1]. Each register
// holds two bf16, the lower index in the low half.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace warp_mma {

// two f32 as two bf16 (round to nearest even) in one register, lo in the
// low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; with live false nothing is read
// and the 16 destination bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (through L1); zero-filled when live is false.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory. Lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); register i gets
// matrix i, lane t holding its row t / 4, columns 2(t % 4) and 2(t % 4)+1:
// a K tile stored [key][d] so loads B fragments of Q K^T.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, transposed: lane t gets rows 2(t % 4) and 2(t % 4)+1 of
// column t / 4, so a V tile stored [key][d] loads B fragments of P V.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace warp_mma
