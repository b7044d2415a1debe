// Causal GQA flash attention over a first prefill chunk, for Hopper (sm_90a).
//
// Replaces: dynamo_tpu/ops/flash_prefill.py::flash_prefill_attention, the
// Pallas kernel _prefill_kernel (pallas_call at flash_prefill.py:484).
//
// Bound on the H100: operations at B*T of a few thousand tokens,
// 4 * Hq * D * (causal query-key pairs) FLOPs per layer against about
// (2*Hq + 2*Hkv) * D * B*T * 2 bytes.
// Design (FA2-style): one CTA per (sequence, kv head, 64-row query tile).
// The g = Hq/Hkv query heads of the kv group fold into the tile's rows
// (row r = head_in_group * (64/g) + token), so each K/V tile staged in
// shared memory serves all g heads. Four warps each own 16 rows: QK^T and
// PV run on the tensor cores through WMMA 16x16x16 bf16 fragments with
// f32 accumulation; the online softmax runs per row in f32 with warp
// shuffles. Key tiles above the causal frontier of the query tile, or at
// or past valid_len, are never loaded. Keys past valid_len inside a
// loaded tile are zero-filled and masked. Tiles whose queries are all
// padding write zeros, so padding rows stay finite. wgmma/TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int ROWS = 64;   // query rows per CTA
constexpr int BK = 64;     // keys per K/V tile
constexpr int WARPS = 4;   // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 8;     // bf16 per 16-byte vector
constexpr float MASKED = -1e30f;

template <int D>
struct Layout {
  static constexpr int QS = D + 8;   // bf16 row stride of the Q, K, V tiles
  static constexpr int SS = BK + 4;  // f32 row stride of the score tile
  static constexpr int PS = BK + 8;  // bf16 row stride of the probability tile
  static constexpr int OS = D + 4;   // f32 row stride of the output tile
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + (size_t)ROWS * QS * 2;
  static constexpr size_t v_off = k_off + (size_t)BK * QS * 2;
  static constexpr size_t s_off = v_off + (size_t)BK * QS * 2;
  static constexpr size_t p_off = s_off + (size_t)ROWS * SS * 4;
  static constexpr size_t o_off = p_off + (size_t)ROWS * PS * 2;
  static constexpr size_t m_off = o_off + (size_t)ROWS * OS * 4;
  static constexpr size_t l_off = m_off + (size_t)ROWS * 4;
  static constexpr size_t bytes = l_off + (size_t)ROWS * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, T, Hq, D]
    const __nv_bfloat16* __restrict__ k,  // [B, T, Hkv, D]
    const __nv_bfloat16* __restrict__ v,  // [B, T, Hkv, D]
    const int* __restrict__ valid_len,    // [B]
    __nv_bfloat16* __restrict__ out,      // [B, T, Hq, D]
    int T, int Hq, int Hkv, float scale) {
  using Lay = Layout<D>;
  constexpr int DV = D / VEC;  // 16-byte vectors per row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + Lay::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::v_off);
  float* ss = reinterpret_cast<float*>(smem + Lay::s_off);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + Lay::p_off);
  float* os = reinterpret_cast<float*>(smem + Lay::o_off);
  float* ms = reinterpret_cast<float*>(smem + Lay::m_off);
  float* ls = reinterpret_cast<float*>(smem + Lay::l_off);

  const int g = Hq / Hkv;
  const int toks = ROWS / g;  // tokens per tile
  const int q0 = blockIdx.x * toks;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int vlen = min(valid_len[b], T);

  if (q0 >= vlen) {
    // every query of this tile is padding: finite zeros, nothing loaded
    const uint4 zero = make_uint4(0, 0, 0, 0);
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
    uint4 val = make_uint4(0, 0, 0, 0);
    if (tok < T) {
      const size_t off = (((size_t)b * T + tok) * Hq + h * g + r / toks) * D;
      val = *reinterpret_cast<const uint4*>(q + off + c * VEC);
    }
    *reinterpret_cast<uint4*>(qs + r * Lay::QS + c * VEC) = val;
  }
  for (int i = tid; i < ROWS * D; i += THREADS) {
    os[(i / D) * Lay::OS + i % D] = 0.f;
  }
  if (tid < ROWS) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }

  const int r0 = warp * 16;
  // keys [0, kend) can matter to some row of this tile (causal frontier)
  const int kend = min(q0 + toks, vlen);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int r = i / DV, c = i % DV;
      const int key = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (key < vlen) {
        const size_t off = (((size_t)b * T + key) * Hkv + h) * D + c * VEC;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + r * Lay::QS + c * VEC) = kv;
      *reinterpret_cast<uint4*>(vs + r * Lay::QS + c * VEC) = vv;
    }
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys of the tile
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + r0 * Lay::QS + kk * 16, Lay::QS);
        wmma::load_matrix_sync(fb, ks + (n * 16) * Lay::QS + kk * 16, Lay::QS);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ss + r0 * Lay::SS + n * 16, acc, Lay::SS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax per row: each lane holds two of the 64 columns
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int tok = q0 + r % toks;
      const int key0 = k0 + lane;
      const int key1 = k0 + lane + 32;
      float s0 = ss[r * Lay::SS + lane] * scale;
      float s1 = ss[r * Lay::SS + lane + 32] * scale;
      if (key0 > tok || key0 >= vlen) s0 = MASKED;
      if (key1 > tok || key1 >= vlen) s1 = MASKED;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m_old - m_new);
      ps[r * Lay::PS + lane] = __float2bfloat16(p0);
      ps[r * Lay::PS + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < D; d += 32) os[r * Lay::OS + d] *= alpha;
      __syncwarp();  // every lane has read ms[r] before lane 0 moves it
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + sum;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + r0 * Lay::OS + n * 16, Lay::OS, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, ps + r0 * Lay::PS + kk * 16, Lay::PS);
        wmma::load_matrix_sync(fb, vs + (kk * 16) * Lay::QS + n * 16, Lay::QS);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(os + r0 * Lay::OS + n * 16, acc, Lay::OS, wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int tok = q0 + r % toks;
    if (tok >= T) continue;
    const float inv = 1.f / fmaxf(ls[r], 1e-30f);
    __nv_bfloat16* dst = out + (((size_t)b * T + tok) * Hq + h * g + r / toks) * D;
    for (int d = lane; d < D; d += 32) dst[d] = __float2bfloat16(os[r * Lay::OS + d] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* valid_len,
           void* out, int B, int T, int Hq, int Hkv, float scale,
           cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int toks = ROWS / (Hq / Hkv);
  const dim3 grid((T + toks - 1) / toks, Hkv, B);
  flash_prefill_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int*)valid_len, (__nv_bfloat16*)out, T, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dyn_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* valid_len, void* out, int B, int T,
                                 int Hq, int Hkv, int D, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || ROWS % (Hq / Hkv) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (D == 64) return launch<64>(q, k, v, valid_len, out, B, T, Hq, Hkv, scale, (cudaStream_t)stream);
  if (D == 128) return launch<128>(q, k, v, valid_len, out, B, T, Hq, Hkv, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
