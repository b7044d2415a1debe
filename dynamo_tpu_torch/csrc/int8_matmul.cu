// Weight-only int8 matrix product for Hopper (sm_90a): out = (x @ w) * scale.
//
// Replaces no Pallas kernel. The reference's `_mm`
// (dynamo_tpu/models/llama.py:1043) computes (x @ w.astype(dtype)) *
// scale[0] for an int8 weight, and XLA streams the int8->bf16 convert and
// the scale into the dot's operand read, so HBM carries one byte a weight.
// PyTorch has no such fusion: `x @ w.to(bf16) * s` writes a bf16 copy of
// the weight and reads it back, 5 bytes a weight against 2 for a bf16
// model. This kernel is the port's counterpart of XLA's fused read: it
// loads the int8 weight and widens it in registers.
//
// Shapes: x [M, K] bf16, w [K, N] int8 ([in, out], the reference's
// layout), scale [N] f32 (one per output channel), out [M, N] bf16, all
// contiguous; K a multiple of BK (64) and N of BN (128).
//
// Bound on the H100: bytes at decode, operations at prefill. The product
// moves K*N weight bytes + 2*M*K + 2*M*N + 4*N and does 2*M*K*N
// operations; at M = 1-128 (decode buckets) the weight read sets the time
// (llama3-1b's seven products: 0.97 GB a step at 3.35 TB/s, 0.29 ms), at
// M in the thousands (prefill chunks) the tensor cores do.
//
// Design (simple first; speed is later work).
// - CTA tile BM x 128 (BM = 16 or 64, the template's MI = BM / 16), K in
//   slices of 64, 4 warps each owning 32 output columns and all BM rows.
// - Two shared-memory stages. x's slice comes by cp.async (16 bytes a
//   copy, rows past M zero-filled); w's slice (8 KB of int8) is loaded as
//   16-byte vectors into registers one slice ahead, so its loads are in
//   flight while the current slice multiplies, then widened to bf16 (exact:
//   |q| <= 127 fits bf16's significand) and stored [k][n] with 16 bytes
//   of row padding. The widening is byte permutes and one f32 subtract a
//   value (`widen4`), not an int->float convert (a quarter-rate
//   instruction, which set the time of the first design at small M).
// - mma.sync m16n8k16 (warp_mma.cuh): A fragments by ldmatrix, B by
//   ldmatrix.trans from the [k][n] tile; f32 accumulators.
// - The epilogue multiplies by the f32 scale and rounds to bf16 once (the
//   reference rounds the product and the scaled product apart).
// - Split-K at small M: a grid of N tiles alone leaves most of the 132 SMs
//   idle when M is small (llama3-1b's 2048-wide outputs are 16 tiles). The
//   wrapper cuts K into `splits` ranges; each CTA writes its f32 partial
//   sums to [splits, M, N] and a second kernel adds them in split order
//   (deterministic: a call gives the same bits every time, so a CUDA graph
//   and an eager call agree) and applies the scale. The wrapper sizes the
//   split from the card's SM count and the shapes only, never from the
//   data: no host sync, and a call captures in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace warp_mma;

constexpr int THREADS = 128;
constexpr int BN = 128;
constexpr int BK = 64;
// bf16 per row of a shared x tile and of a shared w tile (16 bytes of padding,
// so the 8 rows an ldmatrix reads fall on distinct banks)
constexpr int XS = BK + 8;
constexpr int WS = BN + 8;
// 16-byte int8 vectors of a w slice each thread loads
constexpr int W_VECS = BK * BN / 16 / THREADS;
constexpr int REDUCE_THREADS = 256;

template <int MI>
struct Cfg {
  static constexpr int BM = 16 * MI;
  // 16-byte (8 x bf16) copies of an x slice
  static constexpr int X_VECS = BM * BK / 8;
  static constexpr int BYTES = 2 * (BM * XS + BK * WS) * (int)sizeof(__nv_bfloat16);
};

// 4 int8 (one word) as 4 bf16 in two words, lower index in the low half,
// exactly and without an int->float convert: each byte biased by 128 goes
// into the low byte of the f32 2^23 (0x4B000000), so the float is
// 2^23 + 128 + q; subtracting 2^23 + 128 leaves q exactly, and as |q| <=
// 128 needs 8 significant bits its bf16 is the upper half of the f32.
__device__ __forceinline__ void widen4(uint32_t q, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = q ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f;
  }
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// 16 int8 as 16 bf16, in pairs
__device__ __forceinline__ void widen16(const int4 v, uint32_t (&out)[8]) {
  widen4((uint32_t)v.x, out[0], out[1]);
  widen4((uint32_t)v.y, out[2], out[3]);
  widen4((uint32_t)v.z, out[4], out[5]);
  widen4((uint32_t)v.w, out[6], out[7]);
}

template <int MI>
__global__ void __launch_bounds__(THREADS)
    int8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partials, int M, int K, int N, int tiles_per_split) {
  using C = Cfg<MI>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][XS]
  __nv_bfloat16* ws = xs + 2 * C::BM * XS;                      // [2][BK][WS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::BM;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(K / BK, kt0 + tiles_per_split);

  auto load_x = [&](int stage, int kt) {
    for (int c = tid; c < C::X_VECS; c += THREADS) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const bool live = m0 + r < M;
      const __nv_bfloat16* src = x + (size_t)(live ? m0 + r : 0) * K + (size_t)kt * BK + col;
      cp_async16(smem_u32(xs + (stage * C::BM + r) * XS + col), src, live);
    }
  };
  int4 wreg[W_VECS];
  auto load_w = [&](int kt) {
#pragma unroll
    for (int i = 0; i < W_VECS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      wreg[i] = __ldg(reinterpret_cast<const int4*>(w + ((size_t)kt * BK + r) * N + n0 + col));
    }
  };
  auto store_w = [&](int stage) {
#pragma unroll
    for (int i = 0; i < W_VECS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      uint32_t h[8];
      widen16(wreg[i], h);
      uint4* dst = reinterpret_cast<uint4*>(ws + (stage * BK + r) * WS + col);
      dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
      dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
  };

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  if (kt0 < kt1) {
    load_x(0, kt0);
    cp_async_commit();
    load_w(kt0);
    store_w(0);
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int cur = (kt - kt0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage cur is whole; stage cur ^ 1 is read by no warp
    const bool more = kt + 1 < kt1;
    if (more) {
      load_x(cur ^ 1, kt + 1);
      cp_async_commit();
      load_w(kt + 1);  // in flight while stage cur multiplies
    }
    const __nv_bfloat16* xt = xs + cur * C::BM * XS;
    const __nv_bfloat16* wt = ws + cur * BK * WS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        ldmatrix_x4(a[mi], smem_u32(xt + (mi * 16 + (lane & 15)) * XS + kk * 16 + (lane >> 4) * 8));
      }
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        const int mat = lane >> 3;
        const int k = kk * 16 + (mat & 1) * 8 + (lane & 7);
        const int n = warp * 32 + j * 16 + (mat >> 1) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(wt + k * WS + n));
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    if (more) store_w(cur ^ 1);
  }

  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + warp * 32 + ni * 8 + 2 * tq;
    const float2 s = partials == nullptr ? __ldg(reinterpret_cast<const float2*>(scale + n))
                                         : make_float2(1.f, 1.f);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mi * 16 + gr + 8 * h;
        if (m >= M) continue;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (partials != nullptr) {
          *reinterpret_cast<float2*>(partials + ((size_t)blockIdx.z * M + m) * N + n) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) = pack_bf16(v0 * s.x, v1 * s.y);
        }
      }
  }
}

// out = (sum over splits of partials, in split order) * scale, 4 outputs a thread
__global__ void __launch_bounds__(REDUCE_THREADS)
    int8_matmul_reduce(const float* __restrict__ partials, const float* __restrict__ scale,
                       __nv_bfloat16* __restrict__ out, int M, int N, int splits) {
  const long long total = (long long)M * N;
  const long long i = ((long long)blockIdx.x * REDUCE_THREADS + threadIdx.x) * 4;
  if (i >= total) return;
  float4 sum = __ldg(reinterpret_cast<const float4*>(partials + i));
  for (int z = 1; z < splits; ++z) {
    const float4 p = __ldg(reinterpret_cast<const float4*>(partials + z * total + i));
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  const float4 s = __ldg(reinterpret_cast<const float4*>(scale + i % N));
  uint2 v;
  v.x = pack_bf16(sum.x * s.x, sum.y * s.y);
  v.y = pack_bf16(sum.z * s.z, sum.w * s.w);
  *reinterpret_cast<uint2*>(out + i) = v;
}

template <int MI>
int launch(const void* x, const void* w, const void* scale, void* out, void* partials, int M,
           int K, int N, int splits, int tiles_per_split, cudaStream_t stream) {
  using C = Cfg<MI>;
  cudaError_t err = cudaFuncSetAttribute(int8_matmul_kernel<MI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, (M + C::BM - 1) / C::BM, splits);
  int8_matmul_kernel<MI><<<grid, THREADS, C::BYTES, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale, (__nv_bfloat16*)out,
      splits > 1 ? (float*)partials : nullptr, M, K, N, tiles_per_split);
  if (splits > 1) {
    const long long quads = (long long)M * N / 4;
    const int blocks = (int)((quads + REDUCE_THREADS - 1) / REDUCE_THREADS);
    int8_matmul_reduce<<<blocks, REDUCE_THREADS, 0, stream>>>(
        (const float*)partials, (const float*)scale, (__nv_bfloat16*)out, M, N, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// mi: 1 (16-row CTA tiles) or 4 (64-row); K is cut into `splits` ranges of
// `tiles_per_split` slices of BK, none empty. With splits > 1, `partials`
// holds splits * M * N floats.
extern "C" int dyn_int8_matmul(const void* x, const void* w, const void* scale, void* out,
                               void* partials, int M, int K, int N, int mi, int splits,
                               int tiles_per_split, void* stream) {
  const int ktiles = K / BK;
  if (M <= 0 || K <= 0 || N <= 0 || K % BK != 0 || N % BN != 0 || splits < 1 ||
      tiles_per_split < 1 || (long long)splits * tiles_per_split < ktiles ||
      (long long)(splits - 1) * tiles_per_split >= ktiles || (splits > 1 && partials == nullptr) ||
      (long long)(M + 15) / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (mi == 1) return launch<1>(x, w, scale, out, partials, M, K, N, splits, tiles_per_split,
                                (cudaStream_t)stream);
  if (mi == 4) return launch<4>(x, w, scale, out, partials, M, K, N, splits, tiles_per_split,
                                (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
