// Split-KV flash decoding over the paged KV history, for Hopper (sm_90a),
// for bf16 and quantized (int8, fp8) pools.
//
// Replaces: dynamo_tpu/ops/paged_attention.py::paged_decode_attention, the
// Pallas kernel _decode_kernel (pallas_call at paged_attention.py:369),
// which walks a flattened (sequence, page) work list in one grid step;
// with a quantized pool its `quantized` branch dequantizes each page right
// after its DMA (paged_attention.py:83-90, :142-147).
//
// Bound on the H100: bytes. Each history row of K and V is read once,
// 2 * hist * Hkv * D * 2 bytes per sequence per layer for a bf16 pool and
// 2 * hist * Hkv * (D + 4) for a quantized one (narrow values and a f32
// scale), against about 4 * Hq * D FLOPs per history token.
// Design: pass 1 runs one CTA per (split of pages, kv head, sequence);
// the split plan (ops/paged_attention.py::decode_split_plan) cuts each
// page table so the grid has enough CTAs to cover the SMs at small batch.
// A CTA finds its pages through page_tables itself, stages each page's
// [S, D] K and V slices for its kv head in shared memory with 16-byte
// loads, and runs a flash (online softmax) merge in f32 for the g query
// heads of the group, which share every page load. Slots at or past the
// history length are never read. Pass 2 merges the splits of each
// (sequence, head) into the unnormalized (acc, m, l) contract; a sequence
// with no history gives acc=0, m=-inf, l=0.
// A quantized page loads D narrow bytes per row, widened exactly to bf16
// into the same shared tiles, and the page's S scales for the head; the
// scales fold in f32: key j scores ks_j * (q . kq_j), and the value sum
// adds (p_j * vs_j) * vq_j while l sums p_j alone.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <int D, typename T>
__global__ void __launch_bounds__(THREADS) paged_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, Hq, D]
    const T* __restrict__ k_cache,              // [L, P, S, Hkv, D]
    const T* __restrict__ v_cache,
    const float* __restrict__ k_scale,          // [L, P, S, Hkv] (quantized pools)
    const float* __restrict__ v_scale,
    const int* __restrict__ page_tables,        // [B, MP]
    const int* __restrict__ history_lens,       // [B]
    float* __restrict__ part_acc,               // [B, Hkv, splits, g, D]
    float* __restrict__ part_m,                 // [B, Hkv, splits, g]
    float* __restrict__ part_l,
    int layer, int num_pages, int page_size, int Hq, int Hkv, int max_pages,
    int pages_per_split, float scale) {
  constexpr int KS = D + 2;  // bf16 row stride: an odd word stride, so 32
                             // lanes reading 32 rows hit 32 banks
  constexpr int DV = D / 8;  // 16-byte vectors per row
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = gridDim.x;
  const int g = Hq / Hkv;
  const int S = page_size;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [S][KS]
  __nv_bfloat16* vs = ks + S * KS;                               // [S][KS]
  float* qs = reinterpret_cast<float*>(vs + S * KS);             // [g][D]
  float* sc = qs + g * D;                                        // [g][S]
  float* acc = sc + g * S;                                       // [g][D]
  float* mrow = acc + g * D;                                     // [g]
  float* lrow = mrow + g;                                        // [g]
  float* corr = lrow + g;                                        // [g]
  float* kscl = corr + g;                                        // [S] (quantized)
  float* vscl = kscl + S;                                        // [S] (quantized)
  constexpr bool QUANT = kvq::Kv<T>::QUANT;

  const int hist = history_lens[b];
  const int used = min((hist + S - 1) / S, max_pages);
  const int p_begin = split * pages_per_split;
  const int p_end = min(p_begin + pages_per_split, used);

  for (int i = tid; i < g * D; i += THREADS) {
    qs[i] = __bfloat162float(q[((size_t)b * Hq + h * g) * D + i]) * scale;
    acc[i] = 0.f;
  }
  if (tid < g) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }

  const size_t row_stride = (size_t)Hkv * D;  // elements between slots
  const size_t page_stride = (size_t)S * row_stride;
  const size_t layer_off = (size_t)layer * num_pages * page_stride;
  for (int p = p_begin; p < p_end; ++p) {
    const int page = page_tables[b * max_pages + p];
    const int nvalid = min(S, hist - p * S);  // >= 1 for p < used
    const T* kp = k_cache + layer_off + (size_t)page * page_stride + (size_t)h * D;
    const T* vp = v_cache + layer_off + (size_t)page * page_stride + (size_t)h * D;
    __syncthreads();  // the previous page's tiles are no longer read
    if constexpr (QUANT) {
      const size_t srow = ((size_t)layer * num_pages + page) * S * Hkv + h;
      for (int i = tid; i < nvalid; i += THREADS) {
        kscl[i] = k_scale[srow + (size_t)i * Hkv];
        vscl[i] = v_scale[srow + (size_t)i * Hkv];
      }
    }
    for (int i = tid; i < nvalid * DV; i += THREADS) {
      const int slot = i / DV, c = i % DV;
      const uint4 kv = kvq::load8(kp + slot * row_stride + c * 8);
      const uint4 vv = kvq::load8(vp + slot * row_stride + c * 8);
      // 4-byte stores: the padded shared rows are 4- but not 16-byte aligned
      unsigned* kd = reinterpret_cast<unsigned*>(ks + slot * KS + c * 8);
      unsigned* vd = reinterpret_cast<unsigned*>(vs + slot * KS + c * 8);
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    __syncthreads();

    for (int i = tid; i < g * nvalid; i += THREADS) {
      const int row = i / nvalid, slot = i % nvalid;
      const float* qr = qs + row * D;
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(ks + slot * KS);
      float s = 0.f;
#pragma unroll 8
      for (int d2 = 0; d2 < D / 2; ++d2) {
        const float2 kf = __bfloat1622float2(kr[d2]);
        s += qr[2 * d2] * kf.x + qr[2 * d2 + 1] * kf.y;
      }
      sc[row * S + slot] = QUANT ? s * kscl[slot] : s;
    }
    __syncthreads();

    for (int row = warp; row < g; row += WARPS) {
      float mx = -INFINITY;
      for (int slot = lane; slot < nvalid; slot += 32) mx = fmaxf(mx, sc[row * S + slot]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = mrow[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int slot = lane; slot < nvalid; slot += 32) {
        const float pr = expf(sc[row * S + slot] - m_new);
        sc[row * S + slot] = QUANT ? pr * vscl[slot] : pr;  // the value weight
        sum += pr;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float c = expf(m_old - m_new);  // 0 while m_old is -inf
        corr[row] = c;
        mrow[row] = m_new;
        lrow[row] = lrow[row] * c + sum;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * D; i += THREADS) {
      const int row = i / D, d = i % D;
      const float* pr = sc + row * S;
      float a = acc[i] * corr[row];
      for (int slot = 0; slot < nvalid; ++slot) {
        a += pr[slot] * __bfloat162float(vs[slot * KS + d]);
      }
      acc[i] = a;
    }
  }
  __syncthreads();

  const size_t part = ((size_t)b * Hkv + h) * splits + split;
  for (int i = tid; i < g * D; i += THREADS) part_acc[part * g * D + i] = acc[i];
  if (tid < g) {
    part_m[part * g + tid] = mrow[tid];
    part_l[part * g + tid] = lrow[tid];
  }
}

__global__ void paged_decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int Hq, int Hkv,
    int splits, int D) {
  const int bh = blockIdx.x;  // b * Hq + query head
  const int b = bh / Hq;
  const int head = bh % Hq;
  const int g = Hq / Hkv;
  const int h = head / g;
  const int gi = head % g;
  const size_t base = ((size_t)b * Hkv + h) * splits;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_m[(base + s) * g + gi]);
  const bool empty = (m == -INFINITY);
  float l = 0.f;
  if (!empty) {
    for (int s = 0; s < splits; ++s) {
      l += part_l[(base + s) * g + gi] * expf(part_m[(base + s) * g + gi] - m);
    }
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    if (!empty) {
      for (int s = 0; s < splits; ++s) {
        const float w = expf(part_m[(base + s) * g + gi] - m);
        a += part_acc[((base + s) * g + gi) * D + d] * w;
      }
    }
    acc_out[(size_t)bh * D + d] = a;
  }
  if (threadIdx.x == 0) {
    m_out[bh] = m;
    l_out[bh] = l;
  }
}

template <int D, typename T>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
           const void* v_scale, const void* page_tables, const void* history_lens, float* part_acc,
           float* part_m, float* part_l, float* acc, float* m, float* l, int B,
           int Hq, int Hkv, int layer, int num_pages, int page_size,
           int max_pages, int splits, int pages_per_split, float scale,
           cudaStream_t stream) {
  const int g = Hq / Hkv;
  const size_t smem = (size_t)2 * page_size * (D + 2) * 2 +
                      ((size_t)2 * g * D + (size_t)g * page_size + 3 * g + 2 * page_size) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_split_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, Hkv, B);
  paged_decode_split_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const T*)k_cache, (const T*)v_cache,
      (const float*)k_scale, (const float*)v_scale, (const int*)page_tables,
      (const int*)history_lens, part_acc, part_m, part_l, layer, num_pages,
      page_size, Hq, Hkv, max_pages, pages_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine_kernel<<<B * Hq, D, 0, stream>>>(
      part_acc, part_m, part_l, acc, m, l, Hq, Hkv, splits, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
             const void* v_scale, const void* page_tables, const void* history_lens,
             float* part_acc, float* part_m, float* part_l, float* acc, float* m, float* l,
             int B, int Hq, int Hkv, int D, int layer, int num_pages, int page_size,
             int max_pages, int splits, int pages_per_split, float scale, cudaStream_t stream) {
  if (D == 64) {
    return launch<64, T>(q, k_cache, v_cache, k_scale, v_scale, page_tables, history_lens,
                         part_acc, part_m, part_l, acc, m, l, B, Hq, Hkv, layer, num_pages,
                         page_size, max_pages, splits, pages_per_split, scale, stream);
  }
  if (D == 128) {
    return launch<128, T>(q, k_cache, v_cache, k_scale, v_scale, page_tables, history_lens,
                          part_acc, part_m, part_l, acc, m, l, B, Hq, Hkv, layer, num_pages,
                          page_size, max_pages, splits, pages_per_split, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// kind: 0 a bf16 pool, 1 int8, 2 fp8 (e4m3); the scale planes are null for 0.
extern "C" int dyn_paged_decode(const void* q, const void* k_cache,
                                const void* v_cache, const void* k_scale,
                                const void* v_scale, const void* page_tables,
                                const void* history_lens, void* part_acc,
                                void* part_m, void* part_l, void* acc, void* m,
                                void* l, int kind, int B, int Hq, int Hkv, int D,
                                int layer, int num_pages, int page_size,
                                int max_pages, int splits, int pages_per_split,
                                float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || splits <= 0 || pages_per_split <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (kind != 0 && (k_scale == nullptr || v_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  float* pa = (float*)part_acc;
  float* pm = (float*)part_m;
  float* pl = (float*)part_l;
  cudaStream_t st = (cudaStream_t)stream;
#define DYN_DECODE(T)                                                                    \
  launch_d<T>(q, k_cache, v_cache, k_scale, v_scale, page_tables, history_lens, pa, pm, pl, \
              (float*)acc, (float*)m, (float*)l, B, Hq, Hkv, D, layer, num_pages,         \
              page_size, max_pages, splits, pages_per_split, scale, st)
  if (kind == 0) return DYN_DECODE(__nv_bfloat16);
  if (kind == 1) return DYN_DECODE(int8_t);
  if (kind == 2) return DYN_DECODE(__nv_fp8_e4m3);
#undef DYN_DECODE
  return (int)cudaErrorInvalidValue;
}
