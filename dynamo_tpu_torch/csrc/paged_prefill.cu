// Prefill attention for a chunk with history, for Hopper (sm_90a), over
// bf16 and quantized (int8, fp8) pools.
//
// Replaces: dynamo_tpu/ops/flash_prefill.py::paged_prefill_attention, the
// Pallas kernel _hist_kernel (pallas_call at flash_prefill.py:389); with a
// quantized pool its `quantized` branch dequantizes each history page
// after its DMA (flash_prefill.py:125-145, :185-189).
//
// Row t of sequence b attends to its history keys 0 .. hist_lens[b]-1,
// read from the paged pools through page_tables, and causally to the
// current chunk's keys 0 .. t (below cur_lens[b]); one online softmax
// covers both parts.
//
// Bound on the H100: operations once the history is a few hundred tokens,
// 4 * Hq * D * (cur * hist + cur * (cur + 1) / 2) FLOPs per sequence
// against about ((2*Hq + 2*Hkv) * cur + 2*Hkv * hist) * D * 2 bytes (a
// quantized pool reads (D + 4) bytes per history row instead of 2 * D).
// Design (FA2-style, registers): one CTA per (sequence, kv head, 64-row
// query tile), the g = Hq/Hkv query heads of the kv group folded into the
// rows (row r = head_in_group * (64/g) + token), so every K/V tile staged
// in shared memory serves all g heads. Four warps each own 16 rows and
// keep their Q fragments, scores, probabilities and output accumulator in
// registers: QK^T and PV are mma.sync m16n8k16 bf16 products with f32
// accumulation, the score accumulator's layout is reused as PV's A
// operand, and the online softmax runs in f32 on the fragments, reduced
// over the four lanes that share a row. The CTA first walks the history
// in 64-key tiles, finding each key's page through page_tables (only the
// hist_lens mask, which covers a partial last page), then the current
// chunk's K/V tiles from global memory with the causal and cur_lens masks
// and a causal early exit. Nothing holds the whole chunk in shared memory,
// so T has no limit. A tile whose queries are all at or past cur_lens
// (every tile of a sequence with cur_lens 0) writes zeros and returns.
// K/V tiles load synchronously; a cp.async/TMA pipeline and wgmma are
// later work.
// A quantized pool's history tile loads 64 keys of narrow values, widened
// exactly to bf16 into the same shared K/V tiles (so the mma.sync path is
// the bf16 one), and the keys' scales: each score column takes its key's
// k-scale in f32 before the online softmax, and each probability its
// key's v-scale in f32 before it rounds to bf16 as PV's A operand, while
// the denominator sums the unscaled probabilities. The chunk's own K/V
// stay bf16 and unscaled. Keys past the history are masked by selection
// (their tile rows are zeros and their scores -1e30), never by a product
// with a mask or a zero scale.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

constexpr int ROWS = 64;   // query rows per CTA (tokens x heads of the group)
constexpr int BK = 64;     // keys per K/V tile
constexpr int WARPS = 4;   // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 8;     // bf16 per 16-byte vector
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int STRIDE = D + 8;  // bf16 row stride: conflict-free fragment loads
  static constexpr size_t TILE = (size_t)ROWS * STRIDE;  // ROWS == BK
  // Q, K, V tiles, then the history keys' k- and v-scales (quantized pools)
  static constexpr size_t BYTES = 3 * TILE * sizeof(__nv_bfloat16) + 2 * BK * sizeof(float);
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two adjacent bf16 as one operand register (the lower index in the low half)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from two rows of a tile (a column pair of V for PV's B operand)
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  const uint32_t l = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(hi);
  return l | (h << 16);
}

template <int D, typename KV>
__global__ void __launch_bounds__(THREADS) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, T, Hq, D]
    const __nv_bfloat16* __restrict__ k_cur,   // [B, T, Hkv, D]
    const __nv_bfloat16* __restrict__ v_cur,   // [B, T, Hkv, D]
    const KV* __restrict__ k_pool,              // [L, P, S, Hkv, D]
    const KV* __restrict__ v_pool,              // [L, P, S, Hkv, D]
    const float* __restrict__ k_scale,         // [L, P, S, Hkv] (quantized pools)
    const float* __restrict__ v_scale,
    const int* __restrict__ page_tables,       // [B, MP]
    const int* __restrict__ hist_lens,         // [B]
    const int* __restrict__ cur_lens,          // [B]
    __nv_bfloat16* __restrict__ out,           // [B, T, Hq, D]
    int T, int Hq, int Hkv, int layer, int P, int S, int MP, float scale_log2) {
  constexpr int ST = Smem<D>::STRIDE;
  constexpr int DV = D / VEC;  // 16-byte vectors per row
  constexpr int KSTEPS = D / 16;  // k-steps of QK^T
  constexpr int DTILES = D / 8;   // n-tiles of the output
  constexpr int KTILES = BK / 8;  // n-tiles of the scores
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + Smem<D>::TILE;
  __nv_bfloat16* vs = ks + Smem<D>::TILE;
  float* kscl = reinterpret_cast<float*>(vs + Smem<D>::TILE);  // [BK] (quantized)
  float* vscl = kscl + BK;                                      // [BK] (quantized)
  constexpr bool QUANT = kvq::Kv<KV>::QUANT;

  const int g = Hq / Hkv;
  const int toks = ROWS / g;  // tokens per tile
  const int q0 = blockIdx.x * toks;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int cur = min(cur_lens[b], T);
  // history past the page table is not read (the plain version gathers
  // MP * S slots, so both agree)
  const int hist = min(hist_lens[b], MP * S);

  if (q0 >= cur) {
    // every query of this tile is at or past cur_lens: finite zeros
    for (int i = tid; i < ROWS * DV; i += THREADS) {
      const int r = i / DV, c = i % DV;
      const int tok = q0 + r % toks;
      if (tok < T) {
        const size_t off = (((size_t)b * T + tok) * Hq + h * g + r / toks) * D;
        *reinterpret_cast<uint4*>(out + off + c * VEC) = zero;
      }
    }
    return;
  }

  for (int i = tid; i < ROWS * DV; i += THREADS) {
    const int r = i / DV, c = i % DV;
    const int tok = q0 + r % toks;
    uint4 val = zero;
    if (tok < T) {
      const size_t off = (((size_t)b * T + tok) * Hq + h * g + r / toks) * D;
      val = *reinterpret_cast<const uint4*>(q + off + c * VEC);
    }
    *reinterpret_cast<uint4*>(qs + r * ST + c * VEC) = val;
  }
  __syncthreads();

  // fragment coordinates: this lane holds rows gr and gr + 8 of its warp's
  // 16, at columns 2 * tq and 2 * tq + 1 of every 8-wide n-tile
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int r0 = warp * 16;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* base = qs + (r0 + gr) * ST + kk * 16 + 2 * tq;
    qa[kk][0] = ld_pair(base);
    qa[kk][1] = ld_pair(base + 8 * ST);
    qa[kk][2] = ld_pair(base + 8);
    qa[kk][3] = ld_pair(base + 8 * ST + 8);
  }
  const int tok_row[2] = {q0 + (r0 + gr) % toks, q0 + (r0 + gr + 8) % toks};

  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this lane's share of the denominator
  float o[DTILES][4];
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  const int hist_tiles = (hist + BK - 1) / BK;
  // current keys [0, kend) can matter to some row of this tile (causal frontier)
  const int kend = min(q0 + toks, cur);
  const int tiles = hist_tiles + (kend + BK - 1) / BK;
  for (int it = 0; it < tiles; ++it) {
    const bool in_hist = it < hist_tiles;
    const int k0 = (in_hist ? it : it - hist_tiles) * BK;
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int r = i / DV, c = i % DV;
      const int key = k0 + r;
      uint4 kv = zero;
      uint4 vv = zero;
      if (in_hist) {
        if (key < hist) {
          const int page = page_tables[(size_t)b * MP + key / S];
          const size_t row = (((size_t)layer * P + page) * S + key % S) * Hkv + h;
          kv = kvq::load8(k_pool + row * D + c * VEC);
          vv = kvq::load8(v_pool + row * D + c * VEC);
          if (QUANT && c == 0) {
            kscl[r] = k_scale[row];
            vscl[r] = v_scale[row];
          }
        }
      } else if (key < cur) {
        const size_t off = (((size_t)b * T + key) * Hkv + h) * D + c * VEC;
        kv = *reinterpret_cast<const uint4*>(k_cur + off);
        vv = *reinterpret_cast<const uint4*>(v_cur + off);
      }
      *reinterpret_cast<uint4*>(ks + r * ST + c * VEC) = kv;
      *reinterpret_cast<uint4*>(vs + r * ST + c * VEC) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows against the tile's 64 keys
    float s[KTILES][4];
#pragma unroll
    for (int n = 0; n < KTILES; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = ks + (n * 8 + gr) * ST + 2 * tq;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_bf16(s[n], qa[kk], ld_pair(krow + kk * 16), ld_pair(krow + kk * 16 + 8));
      }
    }

    // masks, then the online softmax in the log2 domain
    float mx[2] = {MASKED, MASKED};
#pragma unroll
    for (int n = 0; n < KTILES; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + n * 8 + 2 * tq + (c & 1);
        const bool live =
            in_hist ? key < hist : (key <= tok_row[c >> 1] && key < cur);
        // a history key's k-scale only where it is live: masked keys select
        const float sk = (QUANT && in_hist && live) ? s[n][c] * kscl[n * 8 + 2 * tq + (c & 1)]
                                                    : s[n][c];
        const float x = live ? sk * scale_log2 : MASKED;
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m[j], mx[j]);
      alpha[j] = exp2f(m[j] - m_new);  // 0 on the first tile (m = -inf)
      m[j] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < KTILES; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[n][c] - m[c >> 1]);
        s[n][c] = p;
        rs[c >> 1] += p;
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dn = 0; dn < DTILES; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V: the score fragments of keys 16kk .. 16kk+15 are PV's A
    // operand; a quantized history key's probability takes its v-scale
    // first (a masked key's probability is 0 and its V row zeros)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float w[4] = {1.f, 1.f, 1.f, 1.f};  // keys 16kk + 2tq + {0, 1, 8, 9}
      if (QUANT && in_hist) {
        const int k = kk * 16 + 2 * tq;
        w[0] = k0 + k < hist ? vscl[k] : 0.f;
        w[1] = k0 + k + 1 < hist ? vscl[k + 1] : 0.f;
        w[2] = k0 + k + 8 < hist ? vscl[k + 8] : 0.f;
        w[3] = k0 + k + 9 < hist ? vscl[k + 9] : 0.f;
      }
      uint32_t pa[4];
      pa[0] = kvq::pack2(s[2 * kk][0] * w[0], s[2 * kk][1] * w[1]);
      pa[1] = kvq::pack2(s[2 * kk][2] * w[0], s[2 * kk][3] * w[1]);
      pa[2] = kvq::pack2(s[2 * kk + 1][0] * w[2], s[2 * kk + 1][1] * w[3]);
      pa[3] = kvq::pack2(s[2 * kk + 1][2] * w[2], s[2 * kk + 1][3] * w[3]);
      const __nv_bfloat16* vrow = vs + (kk * 16 + 2 * tq) * ST + gr;
#pragma unroll
      for (int dn = 0; dn < DTILES; ++dn) {
        const __nv_bfloat16* vcol = vrow + dn * 8;
        const uint32_t b0 = ld_col_pair(vcol, vcol + ST);
        const uint32_t b1 = ld_col_pair(vcol + 8 * ST, vcol + 9 * ST);
        mma_bf16(o[dn], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + gr + 8 * j;
    const int tok = tok_row[j];
    if (tok >= T) continue;
    const float inv = 1.f / fmaxf(l[j], 1e-30f);
    __nv_bfloat16* dst = out + (((size_t)b * T + tok) * Hq + h * g + r / toks) * D + 2 * tq;
#pragma unroll
    for (int dn = 0; dn < DTILES; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8) =
          __floats2bfloat162_rn(o[dn][2 * j] * inv, o[dn][2 * j + 1] * inv);
    }
  }
}

template <int D, typename KV>
int launch(const void* q, const void* k_cur, const void* v_cur, const void* k_pool,
           const void* v_pool, const void* k_scale, const void* v_scale,
           const void* page_tables, const void* hist_lens,
           const void* cur_lens, void* out, int B, int T, int Hq, int Hkv, int layer, int P,
           int S, int MP, float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0) return 0;
  const int toks = ROWS / (Hq / Hkv);
  const dim3 grid((T + toks - 1) / toks, Hkv, B);
  paged_prefill_kernel<D, KV><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cur, (const __nv_bfloat16*)v_cur,
      (const KV*)k_pool, (const KV*)v_pool, (const float*)k_scale, (const float*)v_scale,
      (const int*)page_tables,
      (const int*)hist_lens, (const int*)cur_lens, (__nv_bfloat16*)out, T, Hq, Hkv, layer, P,
      S, MP, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename KV>
int launch_d(const void* q, const void* k_cur, const void* v_cur, const void* k_pool,
             const void* v_pool, const void* k_scale, const void* v_scale,
             const void* page_tables, const void* hist_lens, const void* cur_lens, void* out,
             int B, int T, int Hq, int Hkv, int D, int layer, int P, int S, int MP,
             float scale, cudaStream_t st) {
  if (D == 64) {
    return launch<64, KV>(q, k_cur, v_cur, k_pool, v_pool, k_scale, v_scale, page_tables,
                         hist_lens, cur_lens, out, B, T, Hq, Hkv, layer, P, S, MP, scale, st);
  }
  if (D == 128) {
    return launch<128, KV>(q, k_cur, v_cur, k_pool, v_pool, k_scale, v_scale, page_tables,
                          hist_lens, cur_lens, out, B, T, Hq, Hkv, layer, P, S, MP, scale,
                          st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// kind: 0 a bf16 pool, 1 int8, 2 fp8 (e4m3); the scale planes are null for 0.
extern "C" int dyn_paged_prefill(const void* q, const void* k_cur, const void* v_cur,
                                 const void* k_pool, const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* page_tables,
                                 const void* hist_lens, const void* cur_lens, void* out,
                                 int kind, int B, int T, int Hq, int Hkv, int D, int layer,
                                 int P, int S, int MP, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || ROWS % (Hq / Hkv) != 0 || S <= 0 || MP <= 0) {
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
