// Prefill attention for a chunk with history, for Hopper (sm_90a), over
// bf16 and quantized (int8, fp8 e4m3) pools.
//
// Replaces: dynamo_tpu/ops/flash_prefill.py::paged_prefill_attention, the
// Pallas kernel _hist_kernel (:99, pallas_call at :389); with a quantized
// pool its `quantized` branch, which dequantizes each history page after
// its DMA (:185-189).
//
// Row t of sequence b attends to its history keys 0 .. hist_lens[b]-1,
// read from the paged pools through page_tables, and causally to the
// current chunk's keys 0 .. t below cur_lens[b]; one online softmax covers
// both parts. Rows at or past cur_lens are unspecified but finite.
//
// Bound on the H100: 4 * Hq * D * sum_b cur_b * (hist_b + (cur_b + 1) / 2)
// FLOPs (QK^T and PV over the live pairs) over 989e12, against
// ((2 Hq + 2 Hkv) * cur + 2 Hkv * hist) * D * 2 bytes (a quantized history
// row is D + 4 bytes) over 3.35e12: operations bound it once a history is
// a few hundred tokens. llama3-1b at B=4, T=512, hist (0, 512, 1536, 3072),
// cur (512, 512, 300, 512): 22.4 GFLOP, 0.0227 ms; B=1, hist 2,560, cur
// 440: 10.0 GFLOP, 0.0101 ms.
//
// Design: flash_prefill.cu's tiles and products over a paged history,
// with the page walk of paged_attention.cu.
// - CTA and tile: one CTA per (query tile, kv head, sequence), 256 threads
//   in two consumer warpgroups of 64 query rows (one wgmma M each). The
//   g = Hq/Hkv heads of the group fold into the rows token-major (row r is
//   token r / g, head r % g), so a CTA covers toks = floor(128 / g) tokens
//   (32 for llama3-1b) and every 64-key K/V tile in shared memory serves
//   all g heads. Any g up to ROWS (dyn_paged_prefill_rows, which the
//   wrapper reads) is served, and dyn_paged_prefill refuses a larger one:
//   the rows past toks * g (128 % g of them, 2 at g = 7, none where g
//   divides 128) are dead, as in flash_prefill.cu. A dead row loads zeros,
//   takes its CTA's last token for its masks (its scores stay finite) and
//   stores nothing; it never stands for the next CTA's first token, and
//   the warpgroups' first and last tokens count live rows only.
// - Products: S = Q K^T is wgmma m64n64k16 over K-major shared Q and K;
//   O += P V is wgmma m64nDk16 with P in registers (the S accumulator
//   rounded to bf16 in place) and V read MN-major; every bf16 tile is in
//   the 128-byte swizzle (wgmma.cuh). S, P and O never touch shared memory.
// - Asynchronous ring: STAGES bf16 stages of a 64-key K and V tile (2; 3
//   for a quantized pool at D <= 128), filled with cp.async at 16 bytes a thread, one
//   commit group a tile, so the next tile is in flight while one is
//   multiplied, and one barrier a tile frees a stage. The CTA walks the history tiles, each row finding its
//   page through page_tables[b, key / S] (any page size), then the chunk's
//   tiles from k_cur / v_cur up to its causal frontier, through the same
//   ring. Keys at or past a part's length are never read: the copy's
//   source size is 0, which zero-fills them.
// - Quantized pools: a history tile's narrow rows land by cp.async in a
//   staging ring (NARROW_STAGES: 2, 1 at D=256) and its f32 scales in a
//   ring of their own (SCALE_STAGES). While tile j is multiplied, each thread widens its share of
//   tile j+1's bytes exactly to bf16 (kvq::load8: a byte permute and an
//   add for int8, a paired f16 conversion for e4m3) into its swizzled
//   stage; fence.proxy.async and the next tile's barrier make the stores
//   visible to wgmma, so a quantized tile costs no extra barrier. Each
//   live history score takes its key's k-scale in f32 before the online
//   softmax and each probability its v-scale before it rounds to bf16 as
//   PV's A operand; the denominator sums the unscaled probabilities; the
//   chunk's own K/V stay bf16 and unscaled. Each thread reads the scales
//   of the 16 key columns its accumulator holds from shared memory. Slots
//   past a history hold stale bytes (NaN in e4m3) and zero scales: they
//   are zero-filled instead of read, and their scores are masked by
//   selection, so nothing stale reaches a product.
// - Softmax in registers, as in flash_prefill.cu: the online max and sum
//   in f32 on the accumulator fragments, the max reduced over the four
//   lanes that share a row; the factor into the log2 domain is applied in
//   the exponent (one fused multiply-add a score, then ex2.approx).
// - Masks: history tiles below hist and chunk tiles below the warpgroup's
//   first token and below cur skip the mask arithmetic; the last history
//   tile masks key >= hist, the diagonal and cur-edge chunk tiles key > t
//   or key >= cur, by selection (score = -inf). Key 0 of the first tile is
//   live for every row, so every row's max is finite after it. A
//   warpgroup skips chunk tiles above its own frontier and a warpgroup
//   wholly past cur skips all (its rows are written as zeros). A CTA whose
//   queries are all at or past cur writes zeros and returns.
// - Order and launch: the 1-D grid walks query tiles last (longest) first.
//   Grid and launch depend on B, T, Hq and Hkv alone: no length is read on
//   the host, no workspace, no atomic counter, one launch a call.
// - Head dims 64, 96, 128 and 256, on flash_prefill.cu's tiles: every bf16
//   tile is DP = tile_cols(D) columns wide (128 at D=96: Q K^T reads the
//   first D/16 k-steps, V's pad columns are zeroed once and O's are never
//   stored), and D=256 issues P V as two m64n128k16 halves. A quantized
//   pool's narrow rows stay D bytes in the staging ring (96 at D=96, 6
//   chunks of 16) and widen into the padded tile's first D columns.
// - Shared memory per CTA: Q 128 x DP bf16, STAGES x (K + V) 64 x DP bf16,
//   and for quantized pools SCALE_STAGES (3) x 2 x 64 f32 scales and
//   NARROW_STAGES x (K + V) 64 x D bytes, with 1 KiB to align the swizzle
//   atoms: 50,176 bytes (bf16, D=64), 84,480 (int8 or fp8, D=64), 99,328
//   (bf16, D=96 and 128), 158,208 (int8 or fp8, D=96), 166,400 (int8 or
//   fp8, D=128), 197,632 (bf16, D=256) and 231,936 (int8 or fp8, D=256).
//   A quantized pool at D=256 would need about 329,000 bytes with the
//   3-stage ring and two staging stages, over the 232,448 a block may opt
//   into, so it keeps 2 bf16 stages and 1 staging stage: a history tile's
//   narrow rows are copied two tiles ahead, widened one tile ahead, and a
//   second barrier after the widening frees the one staging stage before
//   the next tile's copy; a chunk tile is copied one tile ahead, as with a
//   bf16 pool. At D=64 and 128 the 3-stage ring stays: forced there, the
//   one-staging-stage schedule took 1.04-1.05x (D=64) and 1.01-1.03x
//   (D=128) the 3-stage ring's device time over int8 and fp8 pools
//   (scripts/torch_paged_prefill_variants.py --head-dims 64,128, its B=4
//   chunk beside histories, inputs cold in L2; H100 80GB HBM3, 700 W).
//   Registers (ptxas, CUDA 12.8, sm_90a; no spills): bf16 D=64
//   123, int8 and fp8 D=64 126; bf16 D=96 171, int8 and fp8 D=96 176; bf16
//   D=128 174, int8 and fp8 D=128 180; bf16 D=256 249, int8 and fp8 D=256
//   254. So two CTAs (four warpgroups) share an SM at D=64
//   (__launch_bounds__ caps 128 registers) and one at D=96, 128 and 256. Per thread: the O
//   accumulator (DP/2 floats: 128 at D=256), S (32 floats), P (16 words).
//
// What each fault of the earlier design (64-row CTAs of four warps,
// mma.sync) became:
// - synchronous K/V loads with a barrier on each side of every tile: the
//   cp.async ring, the next tile in flight and one barrier a tile;
// - 64-row CTAs of 16 tokens, so T/16 CTAs streamed each history: 128-row
//   CTAs of 32 tokens, half the CTAs and half the history traffic;
// - mma.sync with V's B fragments built from shared memory two bf16 at a
//   time: wgmma reading K and V from shared memory by descriptor;
// - quantized bytes widened in the load loop (162 registers at D=64, 3
//   CTAs a SM where bf16 had 4): the next tile is widened from a staging
//   ring while this one is multiplied, and every instance runs under one
//   register cap.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"
#include "warp_mma.cuh"
#include "wgmma.cuh"

namespace {

using warp_mma::cp_async16;
using warp_mma::cp_async4;
using warp_mma::cp_async_commit;
using warp_mma::cp_async_wait;
using warp_mma::pack_bf16;
using namespace wgmma;

constexpr int ROWS = 128;    // query rows per CTA: two consumer warpgroups
constexpr int WG_ROWS = 64;  // rows per warpgroup, one wgmma M
constexpr int BK = 64;       // keys per K/V tile
constexpr int THREADS = 256;
constexpr int VEC = 8;       // bf16 per 16-byte chunk
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the special-function unit alone (2 ulp; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D, bool QUANT>
struct Smem {
  static constexpr int DP = tile_cols(D);  // a bf16 tile's columns
  // a quantized pool at D=256: 2 bf16 stages and 1 staging stage, to fit
  static constexpr bool ONE_NARROW = QUANT && D > 128;
  // depth of the bf16 K/V ring: a quantized pool widens one tile ahead of
  // the one being multiplied, so its ring holds one tile more, unless its
  // narrow copies run two tiles ahead instead (ONE_NARROW)
  static constexpr int STAGES = QUANT && !ONE_NARROW ? 3 : 2;
  static constexpr int NARROW_STAGES = ONE_NARROW ? 1 : 2;  // the staging ring
  static constexpr int SCALE_STAGES = 3;  // a tile's scales, copied two tiles ahead
  static constexpr int Q_BYTES = ROWS * DP * 2;
  static constexpr int TILE_BYTES = BK * DP * 2;     // one bf16 K or V tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K, then V
  // a quantized pool's k- and v-scales, [SCALE_STAGES][2][BK] f32
  static constexpr int SCALES = Q_BYTES + STAGES * STAGE_BYTES;
  // then its staging ring: [NARROW_STAGES][K, V][BK][D] narrow rows
  static constexpr int NARROW_BYTES = BK * D;
  static constexpr int STAGING = SCALES + (QUANT ? SCALE_STAGES * 2 * BK * 4 : 0);
  static constexpr int BYTES = STAGING + (QUANT ? NARROW_STAGES * 2 * NARROW_BYTES : 0);
  static constexpr int ALLOC = BYTES + 1024;  // the base is aligned up to 1024
  static_assert(ALLOC <= 232448, "over the shared memory a block may opt into");
};

template <int D, typename KV, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, T, Hq, D]
    const __nv_bfloat16* __restrict__ k_cur,  // [B, T, Hkv, D]
    const __nv_bfloat16* __restrict__ v_cur,  // [B, T, Hkv, D]
    const KV* __restrict__ k_pool,            // [L, P, S, Hkv, D]
    const KV* __restrict__ v_pool,            // [L, P, S, Hkv, D]
    const float* __restrict__ k_scale,        // [L, P, S, Hkv] (quantized pools)
    const float* __restrict__ v_scale,
    const int* __restrict__ page_tables,      // [B, MP]
    const int* __restrict__ hist_lens,        // [B]
    const int* __restrict__ cur_lens,         // [B]
    __nv_bfloat16* __restrict__ out,          // [B, T, Hq, D]
    int B, int T, int Hq, int Hkv, int layer, int P, int S, int MP, float scale_log2) {
  constexpr bool QUANT = kvq::Kv<KV>::QUANT;
  using SM = Smem<D, QUANT>;
  constexpr int DP = SM::DP;
  constexpr bool ONE_NARROW = SM::ONE_NARROW;
  constexpr int CH = D / VEC;   // 16-byte chunks of a bf16 row in memory
  constexpr int NCH = D / 16;   // 16-byte chunks of a narrow row
  static_assert(ROWS * CH % THREADS == 0 && BK * CH % THREADS == 0, "whole copy rounds");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = warp_mma::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);  // `base` as a generic pointer
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
  const int cur = min(cur_lens[b], T);
  // history past the page table is not read (the plain version gathers
  // MP * S slots, so both agree)
  const int hist = max(0, min(hist_lens[b], MP * S));

  if (q0 >= cur) {
    // every query of this CTA is at or past cur_lens: finite zeros
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

  // Q (rows past T zero-filled), committed with the first K/V tile
#pragma unroll
  for (int n = 0; n < ROWS * CH / THREADS; ++n) {
    const int i = tid + n * THREADS;
    const int r = i / CH, c = i % CH;
    const int tok = q0 + r / g;
    const bool load = r < live_rows && tok < T;
    const size_t off = load ? (((size_t)b * T + tok) * Hq + h * g + r % g) * D + c * VEC : 0;
    cp_async16(qs + (uint32_t)((c / 8) * ROWS * 128) + swizzled(r, c % 8), q + off, load);
  }

  const int* pt = page_tables + (size_t)b * MP;
  const int nh = (hist + BK - 1) / BK;  // history tiles
  // chunk keys [0, kend) can matter to some row of this CTA (causal frontier)
  const int kend = min(q0 + toks, cur);
  const int nk = nh + (kend + BK - 1) / BK;
  constexpr int STAGES = SM::STAGES;
  auto stage = [&](int t) { return base + SM::Q_BYTES + (uint32_t)((t % STAGES) * SM::STAGE_BYTES); };
  auto scales = [&](int t) { return SM::SCALES + (t % SM::SCALE_STAGES) * 2 * BK * 4; };  // from base
  auto staging = [&](int t) {
    return SM::STAGING + (t % SM::NARROW_STAGES) * 2 * SM::NARROW_BYTES;
  };
  // the pool row (layer, page, slot, kv head) of live history key `key`
  auto pool_row = [&](int key) {
    return (((size_t)layer * P + pt[key / S]) * S + key % S) * Hkv + h;
  };
  // Pages of a whole number of tiles (S a multiple of 64): a tile's keys
  // share one page, looked up once a tile, one tile ahead of its copies
  // (tiles are issued in order), so no copy waits on the page table.
  const bool whole_pages = S % BK == 0;
  int next_page = whole_pages && nh > 0 ? pt[0] : 0;

  // Tile t's copies: a history tile through the page table (a quantized
  // pool's narrow rows into the staging ring, its scales beside the bf16
  // stage), a chunk tile from k_cur / v_cur, into bf16 stage t % STAGES.
  // Keys past the part's length are zero-filled.
  auto issue = [&](int t) {
    const uint32_t ks = stage(t), vs = ks + SM::TILE_BYTES;
    if (t < nh) {
      const int k0 = t * BK;
      size_t first = 0;  // the pool row of key k0 (whole pages)
      if (whole_pages) {
        first = (((size_t)layer * P + next_page) * S + k0 % S) * Hkv + h;
        if (t + 1 < nh) next_page = pt[(k0 + BK) / S];
      }
      // the pool row of the tile's row r
      auto row_of = [&](int r) {
        return whole_pages ? first + (size_t)r * Hkv : pool_row(k0 + r);
      };
      if constexpr (QUANT) {
        const uint32_t ns = base + staging(t);
#pragma unroll
        for (int n = 0; n < (BK * NCH + THREADS - 1) / THREADS; ++n) {
          const int i = tid + n * THREADS;
          if (BK * NCH % THREADS != 0 && i >= BK * NCH) break;  // D=96: 384 chunks
          const int r = i / NCH, c = i % NCH;
          const bool live = k0 + r < hist;
          const size_t off = live ? row_of(r) * D + c * 16 : 0;
          const uint32_t so = (uint32_t)(r * D + c * 16);
          cp_async16(ns + so, k_pool + off, live);
          cp_async16(ns + SM::NARROW_BYTES + so, v_pool + off, live);
        }
        if (tid < 2 * BK) {
          const int r = tid % BK;
          const bool live = k0 + r < hist;
          const size_t row = live ? row_of(r) : 0;
          cp_async4(base + scales(t) + (uint32_t)(tid * 4), (tid < BK ? k_scale : v_scale) + row,
                    live);
        }
      } else {
#pragma unroll
        for (int n = 0; n < BK * CH / THREADS; ++n) {
          const int i = tid + n * THREADS;
          const int r = i / CH, c = i % CH;
          const bool live = k0 + r < hist;
          const size_t off = live ? row_of(r) * D + c * VEC : 0;
          const uint32_t so = (uint32_t)((c / 8) * BK * 128) + swizzled(r, c % 8);
          cp_async16(ks + so, k_pool + off, live);
          cp_async16(vs + so, v_pool + off, live);
        }
      }
    } else {
      const int k0 = (t - nh) * BK;
#pragma unroll
      for (int n = 0; n < BK * CH / THREADS; ++n) {
        const int i = tid + n * THREADS;
        const int r = i / CH, c = i % CH;
        const bool live = k0 + r < cur;
        const size_t off = live ? (((size_t)b * T + k0 + r) * Hkv + h) * D + c * VEC : 0;
        const uint32_t so = (uint32_t)((c / 8) * BK * 128) + swizzled(r, c % 8);
        cp_async16(ks + so, k_cur + off, live);
        cp_async16(vs + so, v_cur + off, live);
      }
    }
  };

  // A quantized history tile's staged narrow rows, widened exactly to bf16
  // into its swizzled K and V tiles.
  auto widen = [&](int t) {
    const int ns = staging(t);
    const uint32_t ko = stage(t) - base;
#pragma unroll
    for (int n = 0; n < BK * CH / THREADS; ++n) {
      const int i = tid + n * THREADS;
      const int r = i / CH, c = i % CH;
      const uint32_t so = ko + (uint32_t)((c / 8) * BK * 128) + swizzled(r, c % 8);
      const KV* src = reinterpret_cast<const KV*>(sm + ns + r * D + c * VEC);
      *reinterpret_cast<uint4*>(sm + so) = kvq::load8(src);
      *reinterpret_cast<uint4*>(sm + so + SM::TILE_BYTES) = kvq::load8(src + SM::NARROW_BYTES);
    }
  };

  // Tile t is issued while tile t - STAGES + 1 is multiplied; a quantized
  // pool's history tile t is widened while tile t - 1 is multiplied, so one
  // barrier a tile covers a tile's copies and its widening. With one
  // staging stage (ONE_NARROW) a history tile's narrow rows are issued
  // while tile t - 2 is multiplied, and widened, behind a second barrier,
  // before the next narrow copy reuses the stage; a chunk tile is issued
  // while tile t - 1 is multiplied.
  issue(0);  // with Q: one commit group
  cp_async_commit();
  if constexpr (QUANT && !ONE_NARROW) {
    if (1 < nk) issue(1);
    cp_async_commit();
    if (nh > 0) {  // block-uniform
      cp_async_wait<1>();  // this thread's copies of tile 0 have landed
      __syncthreads();     // everyone's have
      widen(0);
    }
  } else if constexpr (ONE_NARROW) {
    if (nh > 0) {  // block-uniform
      cp_async_wait<0>();  // this thread's copies of tile 0 have landed
      __syncthreads();     // everyone's have
      widen(0);
      __syncthreads();     // the staging stage is free
    }
    if (1 < nh) issue(1);  // a history tile's narrow rows (a chunk tile 1 waits for j = 0)
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
  const bool wg_live = wg_first < cur;
  const int col = (lane % 4) * 2;  // this thread's first column in each 8-column block

  // V's pad columns (D=96) in every bf16 stage, never copied or widened
  for (int s = 0; s < STAGES; ++s) zero_pad<D>(stage(s) + SM::TILE_BYTES, BK, tid, THREADS);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < nk; ++j) {
    // this thread's copies of tile j (quantized pools: of tile j + 1, to
    // widen it below) have landed
    cp_async_wait<0>();
    fence_proxy_async();  // this thread's widened stores, for wgmma
    __syncthreads();  // tile j is whole in its stage; every warpgroup is done with tile j - 1
    if constexpr (!ONE_NARROW) {
      if (j + STAGES - 1 < nk) issue(j + STAGES - 1);  // into the stage tile j - 1 used
      cp_async_commit();
      if constexpr (QUANT) {
        if (j + 1 < nh) widen(j + 1);
      }
    } else {
      if (j + 1 < nh) {  // block-uniform
        widen(j + 1);     // into the stage tile j - 1 used
        __syncthreads();  // every thread's share is read: the staging stage is free
      } else if (j + 1 < nk) {
        issue(j + 1);  // a chunk tile, into the stage tile j - 1 used
      }
      if (j + 2 < nh) issue(j + 2);  // a history tile's narrow rows and scales
      cp_async_commit();
    }
    const bool in_hist = j < nh;  // block-uniform
    const int k0 = (in_hist ? j : j - nh) * BK;
    const uint32_t ks = stage(j);
    const uint32_t vs = ks + SM::TILE_BYTES;
    // the tile's k- and v-scales (a quantized pool's history tile)
    const float* kscl = reinterpret_cast<const float*>(sm + scales(j));
    const float* vscl = kscl + BK;
    if (!wg_live || (!in_hist && k0 > wg_last)) continue;  // warpgroup-uniform

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

    // the scores' factor into the log2 domain, applied in the softmax's
    // exponent (positive, so the max commutes with it); a quantized history
    // tile takes each key's k-scale with it, in f32, before the softmax (a
    // masked key's row and scale are zero-filled, and it is selected away
    // below)
    float sl = scale_log2;
    if (QUANT && in_hist) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 sc = *reinterpret_cast<const float2*>(kscl + 8 * i + col);
        const float kx = sc.x * scale_log2, ky = sc.y * scale_log2;
        s[4 * i] *= kx;
        s[4 * i + 1] *= ky;
        s[4 * i + 2] *= kx;
        s[4 * i + 3] *= ky;
      }
      sl = 1.f;
    }
    if (in_hist) {
      if (k0 + BK > hist) {  // the history's last tile
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = k0 + 8 * i + col + (c & 1);
            s[4 * i + c] = key >= hist ? -INFINITY : s[4 * i + c];
          }
        }
      }
    } else if (k0 + BK - 1 > wg_first || k0 + BK > cur) {
      // the diagonal or the cur_lens edge
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + 8 * i + col + (c & 1);
          const int tok = c < 2 ? tok_a : tok_b;
          s[4 * i + c] = (key > tok || key >= cur) ? -INFINITY : s[4 * i + c];
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
    const float mn_a = fmaxf(m_a, mx_a * sl), mn_b = fmaxf(m_b, mx_b * sl);
    const float alpha_a = ex2(m_a - mn_a), alpha_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[4 * i] = ex2(fmaf(s[4 * i], sl, -mn_a));
      s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], sl, -mn_a));
      s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], sl, -mn_b));
      s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], sl, -mn_b));
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
    // P as bf16 A fragments: 16 keys per k-step, the accumulator's 8-column
    // blocks 2kk and 2kk+1; a quantized history key's probability takes
    // its v-scale first
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float2 w0 = make_float2(1.f, 1.f), w1 = w0;
      if (QUANT && in_hist) {
        w0 = *reinterpret_cast<const float2*>(vscl + 16 * kk + col);
        w1 = *reinterpret_cast<const float2*>(vscl + 16 * kk + 8 + col);
      }
      p[kk][0] = pack_bf16(s[8 * kk] * w0.x, s[8 * kk + 1] * w0.y);
      p[kk][1] = pack_bf16(s[8 * kk + 2] * w0.x, s[8 * kk + 3] * w0.y);
      p[kk][2] = pack_bf16(s[8 * kk + 4] * w1.x, s[8 * kk + 5] * w1.y);
      p[kk][3] = pack_bf16(s[8 * kk + 6] * w1.x, s[8 * kk + 7] * w1.y);
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
  // exp2(0)); a warpgroup wholly past cur_lens writes zeros
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

template <int D, typename KV, int MIN_BLOCKS>
int launch(const void* q, const void* k_cur, const void* v_cur, const void* k_pool,
           const void* v_pool, const void* k_scale, const void* v_scale,
           const void* page_tables, const void* hist_lens, const void* cur_lens, void* out,
           int B, int T, int Hq, int Hkv, int layer, int P, int S, int MP, float scale,
           cudaStream_t stream) {
  const int smem = Smem<D, kvq::Kv<KV>::QUANT>::ALLOC;
  auto kernel = paged_prefill_kernel<D, KV, MIN_BLOCKS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int toks = ROWS / (Hq / Hkv);
  const long long blocks = (long long)((T + toks - 1) / toks) * B * Hkv;
  if (blocks <= 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cur, (const __nv_bfloat16*)v_cur,
      (const KV*)k_pool, (const KV*)v_pool, (const float*)k_scale, (const float*)v_scale,
      (const int*)page_tables, (const int*)hist_lens, (const int*)cur_lens,
      (__nv_bfloat16*)out, B, T, Hq, Hkv, layer, P, S, MP, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename KV>
int launch_d(const void* q, const void* k_cur, const void* v_cur, const void* k_pool,
             const void* v_pool, const void* k_scale, const void* v_scale,
             const void* page_tables, const void* hist_lens, const void* cur_lens, void* out,
             int B, int T, int Hq, int Hkv, int D, int layer, int P, int S, int MP,
             float scale, cudaStream_t st) {
  // D=64 fits two CTAs an SM in registers; a 128- or 256-column
  // accumulator takes one
  if (D == 64) {
    return launch<64, KV, 2>(q, k_cur, v_cur, k_pool, v_pool, k_scale, v_scale, page_tables,
                             hist_lens, cur_lens, out, B, T, Hq, Hkv, layer, P, S, MP, scale,
                             st);
  }
  if (D == 96) {
    return launch<96, KV, 1>(q, k_cur, v_cur, k_pool, v_pool, k_scale, v_scale, page_tables,
                             hist_lens, cur_lens, out, B, T, Hq, Hkv, layer, P, S, MP, scale,
                             st);
  }
  if (D == 128) {
    return launch<128, KV, 1>(q, k_cur, v_cur, k_pool, v_pool, k_scale, v_scale, page_tables,
                              hist_lens, cur_lens, out, B, T, Hq, Hkv, layer, P, S, MP, scale,
                              st);
  }
  if (D == 256) {
    return launch<256, KV, 1>(q, k_cur, v_cur, k_pool, v_pool, k_scale, v_scale, page_tables,
                              hist_lens, cur_lens, out, B, T, Hq, Hkv, layer, P, S, MP, scale,
                              st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Query rows per CTA: the most query heads a kv group (Hq / Hkv) may have.
extern "C" int dyn_paged_prefill_rows() { return ROWS; }

// kind: 0 a bf16 pool, 1 int8, 2 fp8 (e4m3); the scale planes are null for 0.
extern "C" int dyn_paged_prefill(const void* q, const void* k_cur, const void* v_cur,
                                 const void* k_pool, const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* page_tables,
                                 const void* hist_lens, const void* cur_lens, void* out,
                                 int kind, int B, int T, int Hq, int Hkv, int D, int layer,
                                 int P, int S, int MP, float scale, void* stream) {
  // a query group of 1 .. ROWS heads: a CTA holds at least one token
  if (Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || Hq / Hkv > ROWS || S <= 0 || MP <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (kind != 0 && (k_scale == nullptr || v_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
#define DYN_PREFILL(TY)                                                                  \
  launch_d<TY>(q, k_cur, v_cur, k_pool, v_pool, k_scale, v_scale, page_tables, hist_lens, \
               cur_lens, out, B, T, Hq, Hkv, D, layer, P, S, MP, scale, st)
  if (kind == 0) return DYN_PREFILL(__nv_bfloat16);
  if (kind == 1) return DYN_PREFILL(int8_t);
  if (kind == 2) return DYN_PREFILL(__nv_fp8_e4m3);
#undef DYN_PREFILL
  return (int)cudaErrorInvalidValue;
}
