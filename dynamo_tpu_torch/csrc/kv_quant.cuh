// Storage types of the paged KV pools, shared by the kernels that read or
// write them (kv_update.cu, paged_attention.cu, paged_prefill.cu).
//
// A pool holds bf16 rows, or quantized rows: int8 or fp8 (e4m3) values
// with one f32 scale per (layer, page, slot, kv head) in a plane beside
// them (dynamo_tpu_torch/ops/kv_quant.py). Every int8 in [-127, 127] and
// every e4m3 value is exact in bf16, so readers widen narrow rows to bf16
// and fold the scales in f32; the bf16 tiles and products stay as they are.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace kvq {

template <typename T>
struct Kv;

template <>
struct Kv<__nv_bfloat16> {
  static constexpr bool QUANT = false;
};

template <>
struct Kv<int8_t> {
  static constexpr bool QUANT = true;
  static constexpr float QMAX = 127.f;
  // half to even, as jnp.round and torch.round
  static __device__ __forceinline__ uint32_t encode(float x) {
    return (uint32_t)(uint8_t)(int8_t)__float2int_rn(x);
  }
  static __device__ __forceinline__ float decode(uint32_t byte) {
    return (float)(int8_t)(uint8_t)byte;
  }
};

template <>
struct Kv<__nv_fp8_e4m3> {
  static constexpr bool QUANT = true;
  static constexpr float QMAX = 448.f;
  // round to nearest even; |x| <= 448 (to rounding) by construction
  static __device__ __forceinline__ uint32_t encode(float x) {
    return (uint32_t)__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  }
  static __device__ __forceinline__ float decode(uint32_t byte) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)byte, __NV_E4M3);
    return __half2float(__half(h));
  }
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight consecutive pool values as eight bf16 (16 bytes): a bf16 pool's
// 16 bytes as they are, a narrow pool's 8 bytes widened exactly.
template <typename T>
__device__ __forceinline__ uint4 load8(const T* p) {
  if constexpr (!Kv<T>::QUANT) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {raw.x, raw.y};
    uint32_t out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t word = w[i / 2] >> (16 * (i % 2));
      out[i] = pack2(Kv<T>::decode(word & 0xffu), Kv<T>::decode((word >> 8) & 0xffu));
    }
    return make_uint4(out[0], out[1], out[2], out[3]);
  }
}

}  // namespace kvq
