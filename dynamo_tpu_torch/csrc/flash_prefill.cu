// Causal GQA flash attention over a first prefill chunk, for Hopper (sm_90a).
//
// Replaces: dynamo_tpu/ops/flash_prefill.py::flash_prefill_attention, the
// Pallas kernel _prefill_kernel (pallas_call at flash_prefill.py:484).
//
// Bound on the H100: for B sequences of valid lengths n_b, at least
// 4 * Hq * D * sum_b n_b (n_b + 1) / 2 FLOPs (QK^T and PV over the causal
// triangle) and (2 * Hq + 2 * Hkv) * D * 2 * sum_b n_b bytes (q, k, v read
// once, out written once); the time bound is the larger of FLOPs / 989e12
// and bytes / 3.35e12. For llama3-1b's main case (B=8, T=512, lens 512,
// 500, 385, 256, 129, 64, 33, 1; Hq 32, Hkv 8, D 64) that is 3.07 GFLOP
// (0.0031 ms) against 19.25 MB (0.00575 ms): bytes bound a ragged batch of
// short sequences, operations bound long ones (n above about 740).
//
// Design (one CTA per (query tile, sequence, kv head), 256 threads):
// - Tiles: 128 query rows per CTA, two consumer warpgroups of 64 rows (one
//   wgmma M each). The g = Hq/Hkv heads of the kv group fold into the rows
//   token-major (row r = token offset r / g, head r % g), so one K/V tile
//   serves all g heads and a CTA covers toks = floor(128 / g) tokens: 32
//   for llama3-1b, so each sequence's K/V prefix is read by T/32 CTAs.
//   Any g up to 128 is served: the rows past toks * g (128 % g of them, 2
//   at g = 7, none where g divides 128) are dead. A dead row loads zeros,
//   takes its CTA's last token for its masks (so its scores stay finite
//   and apart from every live row's, as every row's are) and stores
//   nothing; it never stands for the next CTA's first token, and the
//   warpgroups' first and last tokens count live rows only.
// - Products: S = Q K^T is wgmma m64n64k16 with Q and the K tile both
//   K-major shared-memory operands; O += P V is wgmma m64nDk16 with P as
//   the A operand in registers (the S accumulator rounded to bf16 in
//   place: the accumulator's layout is the A fragment's) and the V tile a
//   shared-memory B operand read MN-major (transposed by the descriptor).
//   Every shared tile is stored in the 128-byte swizzle, 64 columns (128
//   bytes) per row block, so the wgmma reads are conflict-free; the
//   descriptors carry SBO 1024 (eight 128-byte rows) and, for V at D=128,
//   LBO = one 64-column block. The swizzle, descriptors and products are
//   wgmma.cuh's (shared with paged_prefill.cu), the copies warp_mma.cuh's.
// - Softmax in registers: scores are scaled by log2(e) / sqrt(D) and the
//   online max and sum run in f32 on the accumulator fragments with exp2f,
//   the max reduced over the four lanes that share a row. The O
//   accumulator stays in registers for the whole key loop; each thread
//   keeps a partial row sum, reduced once at the end. No S, P or O tile
//   touches shared memory.
// - Asynchronous K/V ring: STAGES (2) buffers of [64 keys, D] K and V,
//   filled with cp.async (16 bytes a thread, one commit group per tile);
//   tile j+1 is in flight while tile j is multiplied. Keys at or past
//   valid_len are zero-filled by the copy (src-size 0), never read.
// - Masks: key tiles above the CTA's causal frontier or at or past
//   valid_len are never loaded; a warpgroup skips the tiles above its own
//   frontier; tiles wholly below its first token and below valid_len skip
//   the mask arithmetic; the diagonal and valid_len-edge tiles mask by
//   selection (score = -inf), never by a product. Key 0 is live for every
//   row of a live CTA, so every row's max is finite after the first tile.
//   A CTA whose queries are all at or past valid_len writes zeros and
//   returns; rows past valid_len in a live CTA attend over all valid keys,
//   so they are finite too.
// - Order: the 1-D grid walks query tiles last (longest) first, so the
//   CTAs with the most key tiles start first and the causal tail is short.
// - Head dims 64, 96, 128 and 256. Every shared tile is DP = tile_cols(D)
//   columns wide, whole 64-column swizzle atoms: a D=96 row sits in a
//   128-column tile (the reference's own lane padding, kv_head_dim, moved
//   from the pool into the tile). Its copies fill columns 0-95; Q K^T runs
//   over the first D/16 k-steps only, so the pad columns of Q and K are
//   never read; V's are zeroed once, before the key loop, so P V (at
//   N=128) adds zeros to O's pad columns, which are never stored. It costs
//   a third more PV work than a 96-wide product. D=256 issues P V as two
//   m64n128k16 halves over V's four atoms (wgmma_pv).
// - Shared memory per CTA: Q 128 x DP bf16 plus STAGES x (K + V) 64 x DP
//   bf16 and nothing else, with 1 KiB to align the swizzle atoms: D=64
//   16 + 32 + 1 KiB (50,176 bytes), D=96 and D=128 32 + 64 + 1 KiB
//   (99,328 bytes), D=256 64 + 128 + 1 KiB (197,632 bytes, under the
//   232,448 a block may opt into). Registers (ptxas, CUDA 12.8, sm_90a):
//   124 a thread at D=64, 158 at D=96, 161 at D=128, 241 at D=256, no
//   spills; so two CTAs (four warpgroups) share an SM at D=64 and one at
//   D=96, 128 and 256. Per thread: the O accumulator (DP/2 floats: 128 at
//   D=256), S (32 floats) and P (16 words).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace wgmma;
using warp_mma::cp_async16;
using warp_mma::cp_async_commit;
using warp_mma::cp_async_wait;
using warp_mma::pack_bf16;

constexpr int ROWS = 128;    // query rows per CTA: two consumer warpgroups
constexpr int WG_ROWS = 64;  // rows per warpgroup, one wgmma M
constexpr int BK = 64;       // keys per K/V tile
constexpr int STAGES = 2;    // depth of the K/V ring
constexpr int THREADS = 256;
constexpr int VEC = 8;       // bf16 per 16-byte chunk
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int DP = tile_cols(D);           // a tile's columns
  static constexpr int Q_BYTES = ROWS * DP * 2;
  static constexpr int TILE_BYTES = BK * DP * 2;    // one K or V tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int BYTES = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int ALLOC = BYTES + 1024;        // the base is aligned up to 1024
};

// One K/V tile (keys k0 .. k0+63) into a ring stage; keys at or past vlen
// are zero-filled.
template <int D>
__device__ __forceinline__ void load_kv(uint32_t ks, uint32_t vs, const __nv_bfloat16* kb,
                                        const __nv_bfloat16* vb, int k0, int vlen, int Hkv,
                                        int tid) {
  constexpr int CH = D / VEC;  // 16-byte chunks per row
#pragma unroll
  for (int n = 0; n < BK * CH / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / CH, c = i % CH;
    const bool live = k0 + r < vlen;
    const size_t off = live ? (size_t)(k0 + r) * Hkv * D + c * VEC : 0;
    const uint32_t so = (uint32_t)((c / 8) * BK * 128) + swizzled(r, c % 8);
    cp_async16(ks + so, kb + off, live);
    cp_async16(vs + so, vb + off, live);
  }
}

template <int D, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, T, Hq, D]
    const __nv_bfloat16* __restrict__ k,  // [B, T, Hkv, D]
    const __nv_bfloat16* __restrict__ v,  // [B, T, Hkv, D]
    const int* __restrict__ valid_len,    // [B]
    __nv_bfloat16* __restrict__ out,      // [B, T, Hq, D]
    int B, int T, int Hq, int Hkv, float scale_log2) {
  using S = Smem<D>;
  constexpr int DP = S::DP;
  constexpr int CH = D / VEC;  // 16-byte chunks of a row in memory
  static_assert(ROWS * CH % THREADS == 0 && BK * CH % THREADS == 0, "whole copy rounds");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;

  const int g = Hq / Hkv;
  const int toks = ROWS / g;       // tokens per CTA
  const int live_rows = toks * g;  // rows at or past it are dead
  const int tiles = (T + toks - 1) / toks;
  // longest first: the last query tile of every (sequence, kv head) first
  const int tile = tiles - 1 - (int)(blockIdx.x / (B * Hkv));
  const int rest = (int)(blockIdx.x % (B * Hkv));
  const int b = rest / Hkv;
  const int h = rest % Hkv;
  const int q0 = tile * toks;
  const int tid = threadIdx.x;
  const int vlen = min(valid_len[b], T);

  if (q0 >= vlen) {
    // every query of this CTA is padding: finite zeros, nothing loaded
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const int tok = q0 + r / g;
      if (r < live_rows && tok < T) {
        const size_t off = (((size_t)b * T + tok) * Hq + h * g + r % g) * D;
        *reinterpret_cast<uint4*>(out + off + c * VEC) = zero;
      }
    }
    return;
  }

  // Q (rows past T zero-filled) with the first K/V tile, one commit group
#pragma unroll
  for (int n = 0; n < ROWS * CH / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / CH, c = i % CH;
    const int tok = q0 + r / g;
    const bool load = r < live_rows && tok < T;
    const size_t off = load ? (((size_t)b * T + tok) * Hq + h * g + r % g) * D + c * VEC : 0;
    cp_async16(qs + (uint32_t)((c / 8) * ROWS * 128) + swizzled(r, c % 8), q + off, load);
  }
  const __nv_bfloat16* kb = k + ((size_t)b * T * Hkv + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * T * Hkv + h) * D;
  // keys [0, kend) can matter to some row of this CTA (causal frontier)
  const int kend = min(q0 + toks, vlen);
  const int nk = (kend + BK - 1) / BK;
  auto k_stage = [&](int s) { return base + S::Q_BYTES + (uint32_t)(s * S::STAGE_BYTES); };
  load_kv<D>(k_stage(0), k_stage(0) + S::TILE_BYTES, kb, vb, 0, vlen, Hkv, tid);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < STAGES - 1; ++s) {
    if (s < nk) load_kv<D>(k_stage(s), k_stage(s) + S::TILE_BYTES, kb, vb, s * BK, vlen, Hkv, tid);
    cp_async_commit();
  }

  const int wg = tid / 128;  // consumer warpgroup
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row_a = wg * WG_ROWS + warp * 16 + lane / 4;  // this thread's rows: a and a + 8
  // a dead row takes the CTA's last live row's token for its masks
  const int tok_a = q0 + min(row_a, live_rows - 1) / g;
  const int tok_b = q0 + min(row_a + 8, live_rows - 1) / g;
  // the warpgroup's first and last tokens, of live rows (a warpgroup's
  // first row is live: live_rows > 128 - g, and = g when g > 64)
  const int wg_first = q0 + (wg * WG_ROWS) / g;
  const int wg_last = q0 + min(wg * WG_ROWS + WG_ROWS - 1, live_rows - 1) / g;
  const bool wg_live = wg_first < vlen;
  const int col = (lane % 4) * 2;  // this thread's first column in each 8-column block

  // V's pad columns (D=96) in every stage, never copied
  for (int s = 0; s < STAGES; ++s) zero_pad<D>(k_stage(s) + S::TILE_BYTES, BK, tid, THREADS);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile j have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have, and every warpgroup is done with tile j - 1
    {
      const int jn = j + STAGES - 1;  // refill the stage tile j - 1 used
      if (jn < nk) {
        const uint32_t st = k_stage(jn % STAGES);
        load_kv<D>(st, st + S::TILE_BYTES, kb, vb, jn * BK, vlen, Hkv, tid);
      }
      cp_async_commit();
    }
    const int k0 = j * BK;
    if (!wg_live || k0 > wg_last) continue;  // warpgroup-uniform
    const uint32_t ks = k_stage(j % STAGES);
    const uint32_t vs = ks + S::TILE_BYTES;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(s[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (uint32_t)((kk % 4) * 32);  // 16 columns within the block
      const uint64_t da = smem_desc(
          qs + (uint32_t)((kk / 4) * ROWS * 128 + wg * WG_ROWS * 128) + off, 16, 1024);
      const uint64_t db = smem_desc(ks + (uint32_t)((kk / 4) * BK * 128) + off, 16, 1024);
      wgmma_ss_m64n64k16(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(s[i]);

#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
    if (k0 + BK - 1 > wg_first || k0 + BK > vlen) {
      // the diagonal or the valid_len edge: mask by selection
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + 8 * i + col + (c & 1);
          const int tok = c < 2 ? tok_a : tok_b;
          s[4 * i + c] = (key > tok || key >= vlen) ? -INFINITY : s[4 * i + c];
        }
      }
    }

    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * i], s[4 * i + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[4 * i] = exp2f(s[4 * i] - mn_a);
      s[4 * i + 1] = exp2f(s[4 * i + 1] - mn_a);
      s[4 * i + 2] = exp2f(s[4 * i + 2] - mn_b);
      s[4 * i + 3] = exp2f(s[4 * i + 3] - mn_b);
      sum_a += s[4 * i] + s[4 * i + 1];
      sum_b += s[4 * i + 2] + s[4 * i + 3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {  // the pad columns stay 0
      o[4 * i] *= alpha_a;
      o[4 * i + 1] *= alpha_a;
      o[4 * i + 2] *= alpha_b;
      o[4 * i + 3] *= alpha_b;
    }
    // P as bf16 A fragments: 16 keys per k-step, the accumulator's n8
    // blocks 2kk and 2kk+1
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) pin(o[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // 16 keys = 16 rows of 128 bytes; LBO is one 64-column block of V
      wgmma_pv<DP>(o, p[kk], vs + (uint32_t)(kk * 16 * 128), BK * 128);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) pin(o[i]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  // l is at least 1 for every row of a live warpgroup (its max contributes
  // exp2(0)); a warpgroup wholly past valid_len writes zeros
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  const int head_a = h * g + row_a % g;
  const int head_b = h * g + (row_a + 8) % g;
  __nv_bfloat16* dst_a = out + (((size_t)b * T + tok_a) * Hq + head_a) * D + col;
  __nv_bfloat16* dst_b = out + (((size_t)b * T + tok_b) * Hq + head_b) * D + col;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (row_a < live_rows && tok_a < T)
      *reinterpret_cast<uint32_t*>(dst_a + 8 * i) = pack_bf16(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
    if (row_a + 8 < live_rows && tok_b < T)
      *reinterpret_cast<uint32_t*>(dst_b + 8 * i) =
          pack_bf16(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
  }
}

template <int D, int MIN_BLOCKS>
int launch(const void* q, const void* k, const void* v, const void* valid_len, void* out,
           int B, int T, int Hq, int Hkv, float scale, cudaStream_t stream) {
  const int smem = Smem<D>::ALLOC;
  auto kernel = flash_prefill_kernel<D, MIN_BLOCKS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int toks = ROWS / (Hq / Hkv);
  const long long blocks = (long long)((T + toks - 1) / toks) * B * Hkv;
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int*)valid_len, (__nv_bfloat16*)out, B, T, Hq, Hkv, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dyn_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* valid_len, void* out, int B, int T, int Hq,
                                 int Hkv, int D, float scale, void* stream) {
  // a query group of 1 .. ROWS heads: a CTA holds at least one token
  if (Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || Hq / Hkv > ROWS) {
    return (int)cudaErrorInvalidValue;
  }
  // D=64 fits two CTAs an SM in registers; a 128- or 256-column
  // accumulator takes one
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return launch<64, 2>(q, k, v, valid_len, out, B, T, Hq, Hkv, scale, st);
  if (D == 96) return launch<96, 1>(q, k, v, valid_len, out, B, T, Hq, Hkv, scale, st);
  if (D == 128) return launch<128, 1>(q, k, v, valid_len, out, B, T, Hq, Hkv, scale, st);
  if (D == 256) return launch<256, 1>(q, k, v, valid_len, out, B, T, Hq, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}
