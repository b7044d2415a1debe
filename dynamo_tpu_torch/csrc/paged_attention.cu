// Split-KV flash decoding over the paged KV history, for Hopper (sm_90a),
// for bf16 and quantized (int8, fp8) pools: one kernel launch per call.
//
// Replaces: dynamo_tpu/ops/paged_attention.py::paged_decode_attention, the
// Pallas kernel _decode_kernel (pallas_call at paged_attention.py:369),
// which streams each sequence's pages through a DEPTH-deep DMA ring
// (:109-134), masks slots past the history by selection (-1e30, :170) and
// merges every page into an f32 flash state with p @ v in f32 (:171-178);
// with a quantized pool its `quantized` branch dequantizes each page after
// its DMA (:83-90, :142-147).
//
// Bound on the H100: bytes. Each history row of K and V is read once:
// 2 * hist * Hkv * D * 2 bytes per sequence for a bf16 pool, 2 * hist *
// Hkv * (D + 4) for a quantized one, against 4 * Hq * D FLOPs per history
// token, about 4 FLOPs a byte at g = Hq / Hkv = 4 where the card's balance
// point is 295. So the design keeps bytes in flight; the tensor cores only
// keep the math off the critical path.
//
// Design. One CTA of four warps per (split of the page table, kv head,
// 16-row tile of the head's group, sequence). The group's g query heads
// are the rows of the products, padded to 16 (a group over 16 runs one
// CTA per 16-row tile, each reading the pages again, mostly from L2, so a
// warp holds one tile's state in registers for any g).
//  - Pages stream through a ring of STAGES = 3 shared stages of BK = 64
//    keys (one page at page size 64), K and V rows of the CTA's kv head,
//    filled with cp.async.cg at 16 bytes a thread and commit/wait groups:
//    while a stage is read the next two are in flight. Each row finds its
//    page through page_tables, so any page size works. Keys at or past
//    the history are zero-filled by the copy (src-size 0) and masked by
//    selection, never read as data nor multiplied by a mask or a scale.
//    One __syncthreads per stage, before its slot is refilled.
//  - Each warp owns 16 keys of every stage and keeps its own online
//    softmax (m, l and the O fragments, f32 in registers) over its whole
//    split. S = Q K^T is mma.sync m16n8k16 (bf16 in, f32 accumulate): Q's
//    fragments load once into registers, bf16 and unscaled, K's by
//    ldmatrix; the softmax scale (and a quantized key's k-scale) applies
//    to S in f32, in the log2 domain. O += P V reuses the S accumulator's
//    layout as the A operand and reads V by ldmatrix.trans. The reference
//    sums P V in f32, so P (times each key's v-scale for a quantized pool)
//    is split into hi = bf16(P) and lo = bf16(P - hi) and both products
//    are issued: about 2^-17 of each term, where one bf16 P errs by 2^-9.
//    Q, K and V are exact in bf16 (a narrow row widens exactly), so S
//    needs no split. The warps merge their states once, at the end,
//    through shared memory; nothing is reduced across warps per stage.
//  - Why mma.sync and not wgmma: wgmma takes 64 rows, and a decode tile
//    has g = 4 live rows (16 after padding here); at 4 FLOPs a byte the
//    tensor cores are nowhere near the limit, and mma.sync lets each warp
//    own its keys with no warpgroup-wide step.
//  - With one live split a CTA writes (acc, m, l) itself. With more, each
//    writes its partial state to the workspace, fences and takes a ticket
//    (atomicAdd on a per-(sequence, kv head, row tile) counter); the CTA
//    that draws the last ticket merges every split in split order, so the
//    result does not depend on which CTA finished last, and resets the
//    counter to 0. Splits past a sequence's history exit at once. A
//    sequence with no history gives acc = 0, m = -inf, l = 0.
//  - A quantized stage holds D narrow bytes a row plus the stage's 64 k-
//    and v-scales (4-byte cp.async); K and V fragments widen exactly to
//    bf16 as they are built (kv_quant.cuh). Key j scores ks_j * (q . kq_j); the
//    value weight is p_j * vs_j in f32 before the hi/lo split, while l
//    sums the unscaled p_j.
//
// Against the earlier split-kernel-and-combine design of this file: loads
// overlap math (a 3-stage cp.async ring with 16-byte copies into 16-byte
// aligned padded rows, where it staged one page synchronously with 4-byte
// shared stores); one barrier per stage instead of four; QK^T and PV on
// tensor cores from registers instead of scalar f32 loops between
// barriers; a split plan from this kernel's resident CTAs per SM
// (ops/paged_attention.py::decode_split_plan, from
// dyn_paged_decode_occupancy) instead of a fixed 2 per SM; one launch per
// call instead of two.
//
// Head dims 64, 96, 128 and 256: KS = D/16 k-steps and DT = D/8 n-tiles
// are whole at each. At D <= 128 a thread holds Q's fragments (D/4
// words) in registers for the whole split; at D=256 those 64 words beside
// a 128-float O fragment would pass the 255-register limit, so Q sits in
// shared memory after the ring ([16][2D + 16] bytes) and each k-step
// loads its fragment by ldmatrix.
//
// Resources (ptxas -O3 for sm_90a, no spills; resident CTAs per SM from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor on an H100 80GB HBM3):
//   bf16 D=64: 128 registers, 55,296 B of shared memory, 4 CTAs a SM;
//   int8 / fp8 D=64: 96 registers, 32,256 B, 5 CTAs (registers bound);
//   bf16 D=128: 166 registers, 104,448 B, 2 CTAs (shared memory bound);
//   int8 / fp8 D=128: 168 / 174 registers, 56,832 B, 2 CTAs by the
//   register file (computed, not queried);
//   bf16 D=96: 128 registers, 79,872 B; int8 / fp8 D=96: 128 / 134, 44,544 B;
//   bf16 D=256: 254 registers, 211,200 B, one CTA a SM; int8 / fp8 D=256:
//   255 (16 bytes of spill stores, 32 of loads) / 244, 114,432 B.
// Shared memory is STAGES stages (the merge buffers reuse them), and Q at
// D=256: a stage is 64 K and 64 V rows of 2D + 16 bytes, or of D + 16
// narrow bytes plus 512 bytes of scales.
// Bytes in flight per SM = 2 stages ahead x bytes per stage x resident
// CTAs: bf16 D=64 2 x 16 KiB x 4 = 128 KiB; int8 / fp8 D=64 2 x 8.5 KiB
// x 5 = 85 KiB; bf16 D=128 2 x 32 KiB x 2 = 128 KiB; against about 25 KB
// a SM that 3.35 TB/s needs over a ~1 us memory latency (3.35 TB/s x
// 1 us / 132 SMs), so latency alone does not hold the kernel back.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"
#include "warp_mma.cuh"

namespace {

using namespace warp_mma;

constexpr int ROWS = 16;     // query rows per CTA: heads of the group, padded
constexpr int BK = 64;       // keys per ring stage
constexpr int STAGES = 3;    // depth of the ring
constexpr int WARPS = 4;     // each warp owns 16 keys of every stage
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SPLITS = 128;  // splits a call may cut (the split merge's shared memory)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D, typename T>
struct Cfg {
  static constexpr bool QUANT = kvq::Kv<T>::QUANT;
  // a shared row is the pool row plus 16 bytes, so the 8 rows of one
  // ldmatrix (or of one lane quad's narrow loads) fall in distinct banks,
  // and every row stays 16-byte aligned for cp.async
  static constexpr int ROW = QUANT ? D + 16 : 2 * D + 16;
  static constexpr int CHUNKS = D * (int)sizeof(T) / 16;  // 16-byte chunks per pool row
  static constexpr int TILE = BK * ROW;
  static constexpr int STAGE = 2 * TILE + (QUANT ? 2 * BK * 4 : 0);
  static constexpr int RING = STAGES * STAGE;
  // Q's fragments from shared memory (D=256), rows of 2D + 16 bytes after
  // the ring, so the 8 rows of one ldmatrix fall in distinct banks
  static constexpr bool Q_SMEM = D > 128;
  static constexpr int QROW = 2 * D + 16;
  static constexpr int LOOP = RING + (Q_SMEM ? ROWS * QROW : 0);
  // the warps' merge: each warp's O [ROWS][D + 8] f32, then m, l and the
  // merge factors [WARPS][ROWS], then the CTA's m and l [ROWS]
  static constexpr int OW = ROWS * (D + 8);
  static constexpr int MERGE = (WARPS * OW + 3 * WARPS * ROWS + 2 * ROWS) * 4;
  // the last CTA's merge of the splits: m (then the factor) and l per
  // (split, row), then the merged m and l [ROWS]
  static constexpr int SPLIT_MERGE = (2 * MAX_SPLITS * ROWS + 2 * ROWS) * 4;
  static constexpr int BYTES = LOOP > MERGE ? (LOOP > SPLIT_MERGE ? LOOP : SPLIT_MERGE)
                                            : (MERGE > SPLIT_MERGE ? MERGE : SPLIT_MERGE);
};

// two narrow pool values (the low 16 bits, the lower index in the low
// byte) as two bf16, exactly
template <typename T>
__device__ __forceinline__ uint32_t widen2(uint32_t two) {
  return pack_bf16(kvq::Kv<T>::decode(two & 0xffu), kvq::Kv<T>::decode((two >> 8) & 0xffu));
}

// a, b as bf16 hi and the rounding remainder as bf16 lo: hi + lo holds
// a and b to about 2^-17
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16(a - h.x, b - h.y);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float4 fma4(float f, float4 x, float4 a) {
  return make_float4(fmaf(f, x.x, a.x), fmaf(f, x.y, a.y), fmaf(f, x.z, a.z),
                     fmaf(f, x.w, a.w));
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,    // [B, Hq, D]
    const T* __restrict__ k_cache,          // [L, P, S, Hkv, D]
    const T* __restrict__ v_cache,
    const float* __restrict__ k_scale,      // [L, P, S, Hkv] (quantized pools)
    const float* __restrict__ v_scale,
    const int* __restrict__ page_tables,    // [B, MP]
    const int* __restrict__ history_lens,   // [B]
    float* __restrict__ partials,           // acc [B, G, splits, ROWS, D], m, l [.., ROWS]
    int* __restrict__ counters,             // [B, G], all 0 between calls
    float* __restrict__ acc_out,            // [B, Hq, D]
    float* __restrict__ m_out,              // [B, Hq]
    float* __restrict__ l_out,
    int layer, int num_pages, int S, int Hq, int Hkv, int max_pages, int per,
    float scale_log2) {
  using C = Cfg<D, T>;
  constexpr bool QUANT = C::QUANT;
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int DT = D / 8;   // n-tiles of O
  constexpr int DV = D / 4;   // float4 per output row
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_ticket;

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int grp = blockIdx.y;  // kv head x row tile
  const int b = blockIdx.z;
  const int g = Hq / Hkv;
  const int row_tiles = (g + ROWS - 1) / ROWS;
  const int h = grp / row_tiles;
  const int head0 = h * g + (grp % row_tiles) * ROWS;  // the tile's first query head
  const int nrows = min(ROWS, (h + 1) * g - head0);
  // history past the page table is not read (the plain version gathers
  // max_pages * S slots, so both agree)
  const int hist = min(history_lens[b], max_pages * S);
  const int used = (hist + S - 1) / S;
  const int n_live = max(1, (used + per - 1) / per);
  if (split >= n_live) return;
  const int k_begin = split * per * S;
  const int k_end = min(k_begin + per * S, hist);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int kw = warp * 16;  // this warp's keys in every stage
  const size_t layer_slots = (size_t)layer * num_pages * S;

  // stage t of this split into ring slot `slot`: 64 keys' K and V rows
  // (and scales), one 16-byte cp.async per chunk, zero-filled past k_end
  auto load_stage = [&](int t, int slot) {
    const int k0 = k_begin + t * BK;
    const uint32_t kdst = smem_u32(smem + slot * C::STAGE);
    const uint32_t vdst = kdst + C::TILE;
    for (int i = tid; i < BK * C::CHUNKS; i += THREADS) {
      const int r = i / C::CHUNKS;
      const int c = i % C::CHUNKS;
      const int key = k0 + r;
      const bool live = key < k_end;
      size_t row = 0;  // the key's (layer, page, slot, kv head) row
      if (live) {
        const int page = page_tables[(size_t)b * max_pages + key / S];
        row = (layer_slots + (size_t)page * S + key % S) * Hkv + h;
      }
      const size_t off = row * D + c * (16 / sizeof(T));
      cp_async16(kdst + r * C::ROW + c * 16, k_cache + off, live);
      cp_async16(vdst + r * C::ROW + c * 16, v_cache + off, live);
      if constexpr (QUANT) {
        if (c == 0) {
          cp_async4(kdst + 2 * C::TILE + r * 4, k_scale + row, live);
          cp_async4(kdst + 2 * C::TILE + BK * 4 + r * 4, v_scale + row, live);
        }
      }
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_stage(t, t);
    cp_async_commit();
  }

  // Q fragments, once: rows gr and gr + 8 of the tile, zero past nrows;
  // at D=256 the tile's rows go to shared memory instead (read after the
  // loop's first barrier)
  constexpr bool Q_SMEM = C::Q_SMEM;
  uint32_t qa[Q_SMEM ? 1 : KS][4];
  if constexpr (Q_SMEM) {
    for (int i = tid; i < ROWS * (D / 8); i += THREADS) {
      const int r = i / (D / 8), c = i % (D / 8);
      const uint4 x = r < nrows ? *reinterpret_cast<const uint4*>(
                                      q + ((size_t)b * Hq + head0 + r) * D + c * 8)
                                : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(smem + C::RING + r * C::QROW + c * 16) = x;
    }
  } else {
    const __nv_bfloat16* q0 = q + ((size_t)b * Hq + head0) * D + 2 * tq;
    const bool r0 = gr < nrows;
    const bool r1 = gr + 8 < nrows;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][0] = r0 ? ld32(q0 + gr * D + kk * 16) : 0u;
      qa[kk][1] = r1 ? ld32(q0 + (gr + 8) * D + kk * 16) : 0u;
      qa[kk][2] = r0 ? ld32(q0 + gr * D + kk * 16 + 8) : 0u;
      qa[kk][3] = r1 ? ld32(q0 + (gr + 8) * D + kk * 16 + 8) : 0u;
    }
  }

  float o[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows gr, gr + 8; log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's share of the denominator

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage t landed
    __syncthreads();              // everyone's did, and stage t-1 is no longer read
    if (t + STAGES - 1 < ntiles) load_stage(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();

    const int k0 = k_begin + t * BK;
    if (k0 + kw >= k_end) continue;  // every key of this warp's slice is past the history
    const unsigned char* kt = smem + (t % STAGES) * C::STAGE;
    const unsigned char* vt = kt + C::TILE;
    const float* kscl = reinterpret_cast<const float*>(kt + 2 * C::TILE);  // quantized
    const float* vscl = kscl + BK;

    // S = Q K^T over the warp's 16 keys: n-tile j holds keys kw + 8j ..
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (Q_SMEM) {  // this k-step's A fragment: matrices (rows 0-7 | 8-15, cols 0-7 | 8-15)
        const int mi = lane >> 3;
        ldmatrix_x4(qa[0], smem_u32(smem + C::RING + ((lane & 7) + 8 * (mi & 1)) * C::QROW +
                                    (kk * 16 + 8 * (mi >> 1)) * 2));
      }
      const uint32_t(&qf)[4] = qa[Q_SMEM ? 0 : kk];
      uint32_t kb[4];  // b0, b1 of n-tile 0, then of n-tile 1
      if constexpr (QUANT) {
        const uint16_t* r0 =
            reinterpret_cast<const uint16_t*>(kt + (kw + gr) * C::ROW + kk * 16 + 2 * tq);
        const uint16_t* r1 = r0 + 4 * C::ROW;  // 8 rows on
        kb[0] = widen2<T>(r0[0]);
        kb[1] = widen2<T>(r0[4]);
        kb[2] = widen2<T>(r1[0]);
        kb[3] = widen2<T>(r1[4]);
      } else {
        const int mi = lane >> 3;
        ldmatrix_x4(kb, smem_u32(kt + (kw + 8 * (mi >> 1) + (lane & 7)) * C::ROW +
                                 (kk * 16 + 8 * (mi & 1)) * 2));
      }
      mma_bf16(s[0], qf, kb[0], kb[1]);
      mma_bf16(s[1], qf, kb[2], kb[3]);
    }

    // masks by selection, then the online softmax in the log2 domain;
    // lane holds keys 2tq, 2tq + 1 of each n-tile for rows gr, gr + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kt_i = kw + 8 * j + 2 * tq + (c & 1);
        const bool live = k0 + kt_i < k_end;
        float f = scale_log2;
        if constexpr (QUANT) f *= kscl[kt_i];
        const float x = live ? s[j][c] * f : -INFINITY;
        s[j][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no live key yet: every p is 0
      alpha[r] = exp2f(m_run[r] - mu[r]);       // 0 while m_run is -inf
      m_run[r] = m_new;
    }
    float w[2][4];  // the value weights: p, or p * v-scale
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[j][c] - mu[c >> 1]);  // 0 for a masked key
        rs[c >> 1] += p;
        if constexpr (QUANT) {
          const int kt_i = kw + 8 * j + 2 * tq + (c & 1);
          w[j][c] = k0 + kt_i < k_end ? p * vscl[kt_i] : 0.f;
        } else {
          w[j][c] = p;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V with P = hi + lo: the S layout is the A operand (keys 2tq,
    // 2tq + 1 from n-tile 0, keys 2tq + 8, 2tq + 9 from n-tile 1)
    uint32_t ph[4], pl[4];
    split_bf16(w[0][0], w[0][1], ph[0], pl[0]);
    split_bf16(w[0][2], w[0][3], ph[1], pl[1]);
    split_bf16(w[1][0], w[1][1], ph[2], pl[2]);
    split_bf16(w[1][2], w[1][3], ph[3], pl[3]);
#pragma unroll
    for (int d2 = 0; d2 < D / 16; ++d2) {
      uint32_t vb[4];  // b0, b1 of n-tile 2 d2, then of n-tile 2 d2 + 1
      if constexpr (QUANT) {
        const unsigned char* c0 = vt + (kw + 2 * tq) * C::ROW + d2 * 16 + gr;
        vb[0] = widen2<T>(c0[0] | c0[C::ROW] << 8);
        vb[1] = widen2<T>(c0[8 * C::ROW] | c0[9 * C::ROW] << 8);
        vb[2] = widen2<T>(c0[8] | c0[C::ROW + 8] << 8);
        vb[3] = widen2<T>(c0[8 * C::ROW + 8] | c0[9 * C::ROW + 8] << 8);
      } else {
        const int mi = lane >> 3;
        ldmatrix_x4_trans(vb, smem_u32(vt + (kw + 8 * (mi & 1) + (lane & 7)) * C::ROW +
                                       (d2 * 16 + 8 * (mi >> 1)) * 2));
      }
      mma_bf16(o[2 * d2], ph, vb[0], vb[1]);
      mma_bf16(o[2 * d2], pl, vb[0], vb[1]);
      mma_bf16(o[2 * d2 + 1], ph, vb[2], vb[3]);
      mma_bf16(o[2 * d2 + 1], pl, vb[2], vb[3]);
    }
  }

  // -- the warps' states merge once, through shared memory ------------------
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* ow = reinterpret_cast<float*>(smem);  // [WARPS][ROWS][D + 8]
  float* mw = ow + WARPS * C::OW;              // [WARPS][ROWS]
  float* lw = mw + WARPS * ROWS;               // [WARPS][ROWS]
  float* fw = lw + WARPS * ROWS;               // [WARPS][ROWS] merge factors
  float* m_cta = fw + WARPS * ROWS;            // [ROWS], log2 domain
  float* l_cta = m_cta + ROWS;                 // [ROWS]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  {
    float* mine = ow + warp * C::OW;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      *reinterpret_cast<float2*>(mine + gr * (D + 8) + dn * 8 + 2 * tq) =
          make_float2(o[dn][0], o[dn][1]);
      *reinterpret_cast<float2*>(mine + (gr + 8) * (D + 8) + dn * 8 + 2 * tq) =
          make_float2(o[dn][2], o[dn][3]);
    }
    if (tq == 0) {
      mw[warp * ROWS + gr] = m_run[0];
      mw[warp * ROWS + gr + 8] = m_run[1];
      lw[warp * ROWS + gr] = l_run[0];
      lw[warp * ROWS + gr + 8] = l_run[1];
    }
  }
  __syncthreads();
  if (tid < ROWS) {
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, mw[w * ROWS + tid]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mv = mw[w * ROWS + tid];
      const float f = mv == -INFINITY ? 0.f : exp2f(mv - mm);
      fw[w * ROWS + tid] = f;
      ll += f * lw[w * ROWS + tid];
    }
    m_cta[tid] = mm;
    l_cta[tid] = ll;
  }
  __syncthreads();
  auto cta_acc = [&](int r, int c) {  // float4 c of row r of the CTA's acc
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(ow + w * C::OW + r * (D + 8) + 4 * c);
      a = fma4(fw[w * ROWS + r], x, a);
    }
    return a;
  };
  const size_t out_row = (size_t)b * Hq + head0;

  if (n_live == 1) {
    for (int i = tid; i < nrows * DV; i += THREADS) {
      const int r = i / DV, c = i % DV;
      *reinterpret_cast<float4*>(acc_out + (out_row + r) * D + 4 * c) = cta_acc(r, c);
    }
    if (tid < nrows) {
      m_out[out_row + tid] = m_cta[tid] == -INFINITY ? -INFINITY : m_cta[tid] * LN2;
      l_out[out_row + tid] = l_cta[tid];
    }
    return;
  }

  // -- several live splits: the partial state, a ticket, the last merges ----
  const size_t pair = (size_t)b * gridDim.y + grp;
  const size_t n_parts = (size_t)gridDim.z * gridDim.y * splits;
  float* part_acc = partials;                       // [pairs][splits][ROWS][D]
  float* part_m = partials + n_parts * ROWS * D;    // [pairs][splits][ROWS]
  float* part_l = part_m + n_parts * ROWS;
  const size_t part = (pair * splits + split) * ROWS;
  for (int i = tid; i < nrows * DV; i += THREADS) {
    const int r = i / DV, c = i % DV;
    *reinterpret_cast<float4*>(part_acc + (part + r) * D + 4 * c) = cta_acc(r, c);
  }
  if (tid < nrows) {
    part_m[part + tid] = m_cta[tid];
    part_l[part + tid] = l_cta[tid];
  }
  __threadfence();  // this CTA's partial state is visible before its ticket
  __syncthreads();
  if (tid == 0) last_ticket = atomicAdd(counters + pair, 1) == n_live - 1;
  __syncthreads();
  if (!last_ticket) return;
  __threadfence();

  // the last CTA: every live split of this (sequence, row tile), in split
  // order; partials are read through L2 (__ldcg), where the others' went
  float* fs = reinterpret_cast<float*>(smem);  // [MAX_SPLITS][ROWS]: m, then the factor
  float* ls = fs + MAX_SPLITS * ROWS;           // [MAX_SPLITS][ROWS]
  float* m_all = ls + MAX_SPLITS * ROWS;        // [ROWS]
  float* l_all = m_all + ROWS;                  // [ROWS]
  const size_t first = pair * splits * ROWS;    // split 0, row 0
  for (int i = tid; i < n_live * nrows; i += THREADS) {
    const int sp = i / nrows, r = i % nrows;
    fs[sp * ROWS + r] = __ldcg(part_m + first + sp * ROWS + r);
    ls[sp * ROWS + r] = __ldcg(part_l + first + sp * ROWS + r);
  }
  __syncthreads();
  if (tid < nrows) {
    float mm = -INFINITY;
    for (int sp = 0; sp < n_live; ++sp) mm = fmaxf(mm, fs[sp * ROWS + tid]);
    float ll = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float mv = fs[sp * ROWS + tid];
      const float f = mv == -INFINITY ? 0.f : exp2f(mv - mm);
      fs[sp * ROWS + tid] = f;
      ll += f * ls[sp * ROWS + tid];
    }
    m_all[tid] = mm;
    l_all[tid] = ll;
  }
  __syncthreads();
  for (int i = tid; i < nrows * DV; i += THREADS) {
    const int r = i / DV, c = i % DV;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* src = reinterpret_cast<const float4*>(part_acc + (first + r) * D) + c;
#pragma unroll 4
    for (int sp = 0; sp < n_live; ++sp) {
      a = fma4(fs[sp * ROWS + r], __ldcg(src + (size_t)sp * ROWS * DV), a);
    }
    *reinterpret_cast<float4*>(acc_out + (out_row + r) * D + 4 * c) = a;
  }
  if (tid < nrows) {
    m_out[out_row + tid] = m_all[tid] == -INFINITY ? -INFINITY : m_all[tid] * LN2;
    l_out[out_row + tid] = l_all[tid];
  }
  if (tid == 0) counters[pair] = 0;  // ready for the next call
}

template <int D_, typename T_>
struct Variant {
  static constexpr int D = D_;
  using T = T_;
};

// f(Variant<D, T>{}) for the pool kind (0 bf16, 1 int8, 2 fp8 e4m3) and D
template <typename F>
int dispatch(int kind, int D, F&& f) {
  if (D == 64) {
    if (kind == 0) return f(Variant<64, __nv_bfloat16>{});
    if (kind == 1) return f(Variant<64, int8_t>{});
    if (kind == 2) return f(Variant<64, __nv_fp8_e4m3>{});
  }
  if (D == 96) {
    if (kind == 0) return f(Variant<96, __nv_bfloat16>{});
    if (kind == 1) return f(Variant<96, int8_t>{});
    if (kind == 2) return f(Variant<96, __nv_fp8_e4m3>{});
  }
  if (D == 128) {
    if (kind == 0) return f(Variant<128, __nv_bfloat16>{});
    if (kind == 1) return f(Variant<128, int8_t>{});
    if (kind == 2) return f(Variant<128, __nv_fp8_e4m3>{});
  }
  if (D == 256) {
    if (kind == 0) return f(Variant<256, __nv_bfloat16>{});
    if (kind == 1) return f(Variant<256, int8_t>{});
    if (kind == 2) return f(Variant<256, __nv_fp8_e4m3>{});
  }
  return (int)cudaErrorInvalidValue;
}

template <int D, typename T>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(paged_decode_kernel<D, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D, T>::BYTES);
}

}  // namespace

// The workspace a call needs, which this file alone lays out: `groups`
// CTAs per (sequence, split), G = Hkv * ceil(g / 16) (kv heads times the
// 16-row tiles of a group), so `counters` holds B * G int32; at most
// `max_splits` splits; and `split_floats` f32 words of partial state per
// (sequence, group, split) when a call cuts more than one split: `partials`
// holds B * G * splits * split_floats floats, acc [B, G, splits, 16, D]
// then m and l [B, G, splits, 16].
extern "C" int dyn_paged_decode_layout(int Hq, int Hkv, int D, int* groups, int* max_splits,
                                       int* split_floats) {
  if (Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || D <= 0) return (int)cudaErrorInvalidValue;
  *groups = Hkv * ((Hq / Hkv + ROWS - 1) / ROWS);
  *max_splits = MAX_SPLITS;
  *split_floats = ROWS * (D + 2);
  return 0;
}

// kind: 0 a bf16 pool, 1 int8, 2 fp8 (e4m3); the scale planes are null for
// 0. `partials` and `counters` are laid out as dyn_paged_decode_layout says
// and hold `partials_len` floats and `counters_len` int32, the counters all
// 0 (the kernel leaves them so); a call refuses a workspace that is too
// small, and with splits = 1 touches neither. The grid is (splits, G, B).
extern "C" int dyn_paged_decode(const void* q, const void* k_cache, const void* v_cache,
                                const void* k_scale, const void* v_scale,
                                const void* page_tables, const void* history_lens,
                                void* partials, long long partials_len, void* counters,
                                long long counters_len, void* acc, void* m, void* l,
                                int kind, int B, int Hq, int Hkv, int D, int layer,
                                int num_pages, int page_size, int max_pages, int splits,
                                int pages_per_split, float scale, void* stream) {
  int groups = 0, max_splits = 0, split_floats = 0;
  if (dyn_paged_decode_layout(Hq, Hkv, D, &groups, &max_splits, &split_floats) != 0 ||
      page_size <= 0 || max_pages <= 0 || splits <= 0 || splits > max_splits ||
      pages_per_split <= 0 || (long long)splits * pages_per_split < max_pages) {
    return (int)cudaErrorInvalidValue;
  }
  const long long pairs = (long long)B * groups;
  if (splits > 1 && (counters_len < pairs ||
                     partials_len < pairs * splits * split_floats)) {
    return (int)cudaErrorInvalidValue;
  }
  if (kind != 0 && (k_scale == nullptr || v_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch(kind, D, [&](auto v) {
    using V = decltype(v);
    cudaError_t err = allow_smem<V::D, typename V::T>();
    if (err != cudaSuccess) return (int)err;
    if (B == 0) return 0;
    const int g = Hq / Hkv;
    const dim3 grid(splits, Hkv * ((g + ROWS - 1) / ROWS), B);
    paged_decode_kernel<V::D, typename V::T>
        <<<grid, THREADS, Cfg<V::D, typename V::T>::BYTES, (cudaStream_t)stream>>>(
            (const __nv_bfloat16*)q, (const typename V::T*)k_cache,
            (const typename V::T*)v_cache, (const float*)k_scale, (const float*)v_scale,
            (const int*)page_tables, (const int*)history_lens, (float*)partials,
            (int*)counters, (float*)acc, (float*)m, (float*)l, layer, num_pages, page_size,
            Hq, Hkv, max_pages, pages_per_split, scale * LOG2E);
    return (int)cudaGetLastError();
  });
}

// The kernel's resident CTAs per SM on the current device for the pool
// kind and D, with its shared memory: the split plan's ctas_per_sm.
extern "C" int dyn_paged_decode_occupancy(int kind, int D, int* ctas_per_sm) {
  return dispatch(kind, D, [&](auto v) {
    using V = decltype(v);
    cudaError_t err = allow_smem<V::D, typename V::T>();
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, paged_decode_kernel<V::D, typename V::T>, THREADS,
        Cfg<V::D, typename V::T>::BYTES);
  });
}
