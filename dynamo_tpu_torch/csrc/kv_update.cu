// Paged KV write for Hopper (sm_90a), for bf16 and quantized (int8, fp8) pools.
//
// Replaces: dynamo_tpu/ops/kv_update.py::paged_write, the Pallas kernel
// _write_kernel (pallas_call at kv_update.py:266), which issues one DMA
// per (sequence, page-run) covering every layer; with a quantized pool
// (its `quantized` branch, kv_update.py:56-75) the wrapper quantizes the
// staged rows first (kv_update.py:191-196) and the DMAs carry the scale
// planes too.
//
// Bound on the H100: bytes. The write moves each run that lands in a
// real page once in and once out and does little arithmetic: per (token,
// kv head) row, 2*D bytes of bf16 in and, for a bf16 pool, 2*D out; for
// a quantized pool D narrow bytes and a 4-byte scale out.
// Design: one block per (run, layer), so a prefill chunk spreads over
// L * B * T/run blocks and a decode step over L * B. A bf16 row (Hkv*D
// elements, contiguous in both layouts) moves as 16-byte vectors,
// neighbouring threads on neighbouring addresses. A quantized pool gives
// each (token, kv head) row D/8 lanes (8 of them at D=64, so a warp takes
// 4 rows at once): each lane loads 16 bytes of bf16 and keeps them in
// registers, the row's lanes reduce its amax with shuffles, and each
// writes its 8 quantized bytes, the row's first lane the scale; K, V and
// both scale planes land in one launch. The quantization is the reference's to the bit: scale =
// max(amax / qmax, 1e-8) and x / scale by IEEE division (no reciprocal,
// no fast math), rounded half to even for int8 and saturated round to
// nearest for e4m3. A run whose first token is padding belongs to no
// sequence: the Pallas kernel sends it to the null page 0, whose contents
// are unspecified and which no page table names, so this kernel skips it
// and moves no bytes for it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

// Quantize `rows` rows of d bf16 values (d/8 a power of two up to 32) into
// narrow values and one scale each: every lane holds 8 values (16 bytes)
// of a row in registers, d/8 lanes share a row and reduce its amax with
// shuffles, and a warp takes 32/(d/8) rows at a time.
template <typename T>
__device__ __forceinline__ void quantize_rows(const __nv_bfloat16* __restrict__ x,
                                              uint8_t* __restrict__ q,
                                              float* __restrict__ scale, int rows, int d,
                                              int first_row, int row_step, int lane) {
  const int lpr = d / 8;  // lanes per row
  const int sub = lane / lpr, sl = lane % lpr;
  for (int base = first_row; base < rows; base += row_step) {
    const int i = base + sub;
    const bool live = i < rows;  // every lane joins the shuffles
    const uint4 raw = live ? *reinterpret_cast<const uint4*>(x + (size_t)i * d + sl * 8)
                           : make_uint4(0, 0, 0, 0);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float f[8];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      f[2 * j] = v.x;
      f[2 * j + 1] = v.y;
      amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
    }
    for (int o = lpr / 2; o > 0; o >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const float s = fmaxf(amax / kvq::Kv<T>::QMAX, 1e-8f);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) packed[j / 4] |= kvq::Kv<T>::encode(f[j] / s) << (8 * (j % 4));
    if (live) {
      *reinterpret_cast<uint2*>(q + (size_t)i * d + sl * 8) = make_uint2(packed[0], packed[1]);
      if (sl == 0) scale[i] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) paged_write_kernel(
    const __nv_bfloat16* __restrict__ k_stage,  // [L, B, T, Hkv, D]
    const __nv_bfloat16* __restrict__ v_stage,
    T* __restrict__ k_cache,                    // [L, P, S, Hkv, D]
    T* __restrict__ v_cache,
    float* __restrict__ k_scale,                // [L, P, S, Hkv] (quantized pools)
    float* __restrict__ v_scale,
    const int* __restrict__ page_tables,        // [B, MP]
    const int* __restrict__ positions,          // [B, T]
    const unsigned char* __restrict__ valid,    // [B, T] bool
    int num_pages, int page_size, int batch, int tokens, int max_pages,
    int run, int hkv, int d, int row_bytes) {
  const int runs_per_seq = tokens / run;
  const int r = blockIdx.x;
  const int layer = blockIdx.y;
  const int b = r / runs_per_seq;
  const int first = b * tokens + (r % runs_per_seq) * run;  // [B, T] index
  if (!valid[first]) return;  // a padding run: nothing to land
  const int pos = positions[first];
  const int page = page_tables[b * max_pages + pos / page_size];
  const int slot0 = pos % page_size;
  const long long src_row = (long long)layer * batch * tokens + first;  // token rows
  const long long dst_row = ((long long)layer * num_pages + page) * page_size + slot0;
  if constexpr (!kvq::Kv<T>::QUANT) {
    const int row_vecs = row_bytes / 16;  // 16-byte vectors per token row (any dtype)
    const uint4* ks = reinterpret_cast<const uint4*>(k_stage) + src_row * row_vecs;
    const uint4* vs = reinterpret_cast<const uint4*>(v_stage) + src_row * row_vecs;
    uint4* kc = reinterpret_cast<uint4*>(k_cache) + dst_row * row_vecs;
    uint4* vc = reinterpret_cast<uint4*>(v_cache) + dst_row * row_vecs;
    const long long n = (long long)run * row_vecs;
    for (long long i = threadIdx.x; i < n; i += THREADS) {
      kc[i] = ks[i];
      vc[i] = vs[i];
    }
  } else {
    // the run's (token, kv head) rows are contiguous in the stage, the
    // pool and the scale plane alike
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int per_warp = 32 / (d / 8);
    const long long src = src_row * hkv * d;
    const long long dst = dst_row * hkv;  // first row of the run in the pool and its plane
    quantize_rows<T>(k_stage + src, reinterpret_cast<uint8_t*>(k_cache) + dst * d,
                     k_scale + dst, run * hkv, d, warp * per_warp, WARPS * per_warp, lane);
    quantize_rows<T>(v_stage + src, reinterpret_cast<uint8_t*>(v_cache) + dst * d,
                     v_scale + dst, run * hkv, d, warp * per_warp, WARPS * per_warp, lane);
  }
}

template <typename T>
int launch(const void* k_stage, const void* v_stage, void* k_cache, void* v_cache,
           void* k_scale, void* v_scale, const void* page_tables, const void* positions,
           const void* valid, int layers, int num_pages, int page_size, int batch,
           int tokens, int max_pages, int run, int hkv, int d, int row_bytes,
           cudaStream_t stream) {
  if (batch == 0 || tokens == 0) return 0;
  const dim3 grid(batch * (tokens / run), layers);
  paged_write_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const __nv_bfloat16*)k_stage, (const __nv_bfloat16*)v_stage, (T*)k_cache,
      (T*)v_cache, (float*)k_scale, (float*)v_scale, (const int*)page_tables,
      (const int*)positions, (const unsigned char*)valid, num_pages, page_size, batch,
      tokens, max_pages, run, hkv, d, row_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 a pool of the staged dtype (bf16 on the model path; its token
// rows of row_bytes are copied), 1 int8, 2 fp8 (e4m3); the scale planes
// are null for 0.
extern "C" int dyn_paged_write(const void* k_stage, const void* v_stage,
                               void* k_cache, void* v_cache, void* k_scale,
                               void* v_scale, const void* page_tables,
                               const void* positions, const void* valid, int kind,
                               int layers, int num_pages, int page_size, int batch,
                               int tokens, int max_pages, int run, int hkv, int d,
                               int row_bytes, void* stream) {
  if (run <= 0 || tokens % run != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0) {
    if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(k_stage, v_stage, k_cache, v_cache, k_scale, v_scale,
                                 page_tables, positions, valid, layers, num_pages,
                                 page_size, batch, tokens, max_pages, run, hkv, d,
                                 row_bytes, st);
  }
  if (d % 8 != 0 || d > 256 || 32 % (d / 8) != 0 || k_scale == nullptr || v_scale == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (kind == 1) {
    return launch<int8_t>(k_stage, v_stage, k_cache, v_cache, k_scale, v_scale, page_tables,
                          positions, valid, layers, num_pages, page_size, batch, tokens,
                          max_pages, run, hkv, d, row_bytes, st);
  }
  if (kind == 2) {
    return launch<__nv_fp8_e4m3>(k_stage, v_stage, k_cache, v_cache, k_scale, v_scale,
                                 page_tables, positions, valid, layers, num_pages, page_size,
                                 batch, tokens, max_pages, run, hkv, d, row_bytes, st);
  }
  return (int)cudaErrorInvalidValue;
}
