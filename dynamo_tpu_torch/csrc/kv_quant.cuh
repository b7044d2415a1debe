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

#include "warp_mma.cuh"

namespace kvq {

using warp_mma::pack_bf16;

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
  // four values (one word, the first in the low byte) as four bf16: each
  // byte x + 128 below 2^23's mantissa, less 2^23 + 128, which is exact and
  // spends a byte permute and an add where a conversion is quarter-rate
  static __device__ __forceinline__ uint2 widen4(uint32_t word) {
    const uint32_t u = word ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | k)) - 8388736.f;
    }
    return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
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
  // four values (one word, the first in the low byte) as four bf16, two
  // at a time through f16 (exact: e4m3 fits f16, and its 4 significant
  // bits fit bf16)
  static __device__ __forceinline__ uint2 widen4(uint32_t word) {
    const __half2_raw lo =
        __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(word & 0xffffu), __NV_E4M3);
    const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(word >> 16), __NV_E4M3);
    const float2 a = __half22float2(__half2(lo));
    const float2 b = __half22float2(__half2(hi));
    return make_uint2(pack_bf16(a.x, a.y), pack_bf16(b.x, b.y));
  }
};

// Eight consecutive pool values as eight bf16 (16 bytes): a bf16 pool's
// 16 bytes as they are, a narrow pool's 8 bytes widened exactly.
template <typename T>
__device__ __forceinline__ uint4 load8(const T* p) {
  if constexpr (!Kv<T>::QUANT) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const uint2 a = Kv<T>::widen4(raw.x);
    const uint2 b = Kv<T>::widen4(raw.y);
    return make_uint4(a.x, a.y, b.x, b.y);
  }
}

}  // namespace kvq
