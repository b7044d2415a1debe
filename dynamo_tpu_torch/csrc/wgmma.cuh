// Warpgroup building blocks for sm_90a kernels whose tiles sit in shared
// memory under the 128-byte swizzle and are multiplied by wgmma: the
// swizzled layout, the shared-memory matrix descriptor, the proxy fence
// between generic-proxy stores (cp.async, st.shared) and wgmma's reads, and
// the products the attention kernels use (S = Q K^T from two K-major shared
// operands, O += P V with P in registers and V read MN-major, at 64, 128
// or 256 columns), and the tile width of a head dim with its pad's zeros.
// Used by
// flash_prefill.cu and paged_prefill.cu.
//
// A tile of 64-column (128-byte) row blocks: row r's 16-byte chunk c (0..7)
// sits at r * 128 + ((c ^ (r % 8)) << 4) of its block; a wider row
// continues in the next block, one block after the other. Descriptors carry
// SBO 1024 (eight 128-byte rows) and, for an MN-major operand wider than 64
// columns, LBO = one block.
//
// Accumulator layout of wgmma m64nNk16 (f32): warp w of the warpgroup owns
// rows 16w .. 16w+15; lane = 4 * gr + tq holds, for each 8-column block i,
// d[4i], d[4i+1] = D[16w + gr][8i + 2tq .. 8i + 2tq + 1] and d[4i+2],
// d[4i+3] = D[16w + gr + 8][same columns]. An A operand in registers for
// one k-step of 16 takes the same layout for blocks 2kk and 2kk+1, so a
// score accumulator rounded to bf16 in place is PV's A operand.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wgmma {

// Byte offset of 16-byte chunk `c` (0..7) of row `r` in a region of
// 128-byte rows under the 128-byte swizzle (chunk index ^= row % 8).
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// shared-memory writes by the generic proxy (cp.async, st.shared) made
// visible to wgmma's reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Columns of a shared tile that holds rows of d values: d rounded up to
// whole 64-column (128-byte) swizzle atoms, so a D=96 row sits in a
// 128-column tile whose last 32 columns the kernel zero-fills (V, zero_pad)
// or never reads (Q and K: Q K^T runs over the first D/16 k-steps only).
__host__ __device__ constexpr int tile_cols(int d) { return (d + 63) / 64 * 64; }

// Zeros in columns D .. tile_cols(D) - 1 of a swizzled tile of `rows` rows
// at shared address `tile` (64-column blocks rows * 128 bytes apart), which
// no copy fills, so that P V adds zeros there; by st.shared, so the
// caller's fence_proxy_async and barrier order them before any wgmma.
template <int D>
__device__ __forceinline__ void zero_pad(uint32_t tile, int rows, int tid, int threads) {
  constexpr int CH = D / 8, PAD = (tile_cols(D) - D) / 8;  // 16-byte chunks
  if constexpr (PAD > 0) {
    for (int i = tid; i < rows * PAD; i += threads) {
      const int r = i / PAD, c = CH + i % PAD;
      const uint32_t a = tile + (uint32_t)((c / 8) * rows * 128) + swizzled(r, c % 8);
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(a), "r"(0) : "memory");
    }
  }
}

// keep the compiler from moving accesses of an accumulator register
// across the asynchronous wgmma that owns it
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (each in 16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// S (64 x 64, f32) = A (64 x 16, K-major in shared memory) * B (64 x 16,
// K-major in shared memory)^T; accumulate 0 overwrites S.

__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t a_desc,
                                                   uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// O (64 x 128) += P V as above, into d[OFF .. OFF + 63] of a wider
// accumulator (two of them cover 256 columns)
template <int OFF = 0, int N>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[N], const uint32_t (&a)[4],
                                                    uint64_t b_desc) {
  static_assert(OFF >= 0 && OFF + 64 <= N, "accumulator slice");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// O (64 x DP, f32) += P (64 x 16, bf16 A fragments) * V (16 x DP, MN-major
// from shared address v, 64-column blocks `lbo` bytes apart): DP 64 and
// 128 in one product, 256 in two m64n128k16 halves over V's blocks 0-1
// and 2-3 (the accumulator's 8-column blocks 0-15 and 16-31)
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4], uint32_t v,
                                         uint32_t lbo) {
  static_assert(DP == 64 || DP == 128 || DP == 256, "a tile of 64, 128 or 256 columns");
  if constexpr (DP == 64) {
    wgmma_rs_m64n64k16(o, a, smem_desc(v, lbo, 1024));
  } else if constexpr (DP == 128) {
    wgmma_rs_m64n128k16(o, a, smem_desc(v, lbo, 1024));
  } else {
    wgmma_rs_m64n128k16<0>(o, a, smem_desc(v, lbo, 1024));
    wgmma_rs_m64n128k16<64>(o, a, smem_desc(v + 2 * lbo, lbo, 1024));
  }
}

}  // namespace wgmma
