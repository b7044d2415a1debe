// The paged KV write with its rows moved by 1D bulk copies, a design
// timed against dynamo_tpu_torch/csrc/kv_update.cu by
// scripts/torch_paged_write_variants.py (its `bulk` build). Same C entry
// point, same work units' runs and grid rule, same quantization to the
// bit; only how the bytes move differs.
//
// - Each block walks the units with a stride of the grid and keeps two in
//   flight: while it lands one, the next unit's staged K and V rows (one
//   contiguous span each) are on their way into shared memory by
//   cp.async.bulk, completing on that stage's mbarrier. No thread spends a
//   register or an instruction on a load.
// - A bf16 pool's span goes out of shared memory by cp.async.bulk as it
//   came in.
// - A quantized pool's rows are quantized from shared memory into a
//   narrow tile (the row's D/8 lanes reduce its amax by shuffles, then
//   divide), which one cp.async.bulk per K and V lands in the pool. The
//   scales go out by plain stores: a span of Hkv x 4 bytes starting at an
//   odd slot misses a bulk copy's 16-byte alignment.
// - A unit is 8 KB of bf16 K and as much V: 512 16-byte vectors (bf16
//   pool) or 4096 / D (token, kv head) rows (quantized pool). Two stages
//   of 16 KB and, for a quantized pool, an 8 KB narrow tile: 32 or 40 KB
//   of shared memory a block.
// - Every span is a multiple of 16 bytes at a 16-byte aligned address:
//   rows of 2*D (in) and D (quantized, out) bytes, token rows of a bf16
//   pool checked by the entry point.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "kv_quant.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int UNIT_BYTES = 8192;           // of K, and of V
constexpr int UNIT_VECS = UNIT_BYTES / 16;  // bf16 pools
constexpr int MAX_DEVICES = 64;

struct Args {
  const __nv_bfloat16* k_stage;  // [L, B, T, Hkv, D]
  const __nv_bfloat16* v_stage;
  void* k_cache;                 // [L, P, S, Hkv, D]
  void* v_cache;
  float* k_scale;                // [L, P, S, Hkv] (quantized pools)
  float* v_scale;
  const int* page_tables;        // [B, MP]
  const int* positions;          // [B, T]
  const unsigned char* valid;    // [B, T] bool
  int num_pages, page_size, batch, tokens, max_pages, run, hkv;
  int row_vecs;                  // 16-byte vectors of a token row (bf16 pools)
  int runs_per_seq, runs;        // runs of a sequence, of a layer
  int chunks;                    // units of a run
  int units;                     // units of the call
};

struct Unit {
  int layer, b, first, chunk;
};

__device__ __forceinline__ Unit unit_at(const Args& a, int u) {
  Unit w;
  w.chunk = u % a.chunks;
  const int lr = u / a.chunks;
  const int r = lr % a.runs;
  w.layer = lr / a.runs;
  w.b = r / a.runs_per_seq;
  w.first = w.b * a.tokens + (r % a.runs_per_seq) * a.run;
  return w;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every bulk store issued so far has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ float amax8(uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    m = fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y)));
  }
  return m;
}

template <typename T>
__device__ __forceinline__ uint2 quantize8(uint4 raw, float s) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    packed[j / 2] |= (kvq::Kv<T>::encode(v.x / s) | kvq::Kv<T>::encode(v.y / s) << 8)
                     << (16 * (j % 2));
  }
  return make_uint2(packed[0], packed[1]);
}

// A unit's span: its first row (token row of a bf16 pool, (token, kv
// head) row of a quantized one) in the stage and its count.
template <typename T, int D>
__device__ __forceinline__ void span(const Args& a, const Unit& w, long long* first, int* n) {
  const long long src_row = (long long)w.layer * a.batch * a.tokens + w.first;
  if constexpr (!kvq::Kv<T>::QUANT) {
    const long long total = (long long)a.run * a.row_vecs;  // vectors of the run
    const long long start = (long long)w.chunk * UNIT_VECS;
    *first = src_row * a.row_vecs + start;  // in vectors
    *n = (int)min((long long)UNIT_VECS, total - start);
  } else {
    constexpr int ROWS = UNIT_BYTES / (2 * D);
    const int total = a.run * a.hkv;
    *first = src_row * a.hkv + w.chunk * ROWS;  // in rows
    *n = min(ROWS, total - w.chunk * ROWS);
  }
}

template <typename T, int D>
__device__ __forceinline__ int span_bytes(int n) {
  if constexpr (!kvq::Kv<T>::QUANT) {
    return n * 16;
  } else {
    return n * D * 2;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) paged_write_bulk_kernel(const Args a) {
  constexpr bool QUANT = kvq::Kv<T>::QUANT;
  __shared__ __align__(128) unsigned char in[2][2][UNIT_BYTES];  // [stage][K, V]
  __shared__ __align__(128) unsigned char out[QUANT ? 2 : 1][QUANT ? UNIT_BYTES / 2 : 16];
  __shared__ uint64_t bar[2];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bar[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // unit u's rows into stage s (thread 0, for a live unit)
  auto issue = [&](int u, int s) {
    long long first;
    int n;
    span<T, D>(a, unit_at(a, u), &first, &n);
    const int bytes = span_bytes<T, D>(n);
    const long long off = QUANT ? first * D * 2 : first * 16;  // bytes into the stage
    bar_expect(&bar[s], 2 * bytes);
    bulk_load(in[s][0], reinterpret_cast<const unsigned char*>(a.k_stage) + off, bytes, &bar[s]);
    bulk_load(in[s][1], reinterpret_cast<const unsigned char*>(a.v_stage) + off, bytes, &bar[s]);
  };

  int u = blockIdx.x;
  bool live = u < a.units && a.valid[unit_at(a, u).first];
  if (tid == 0 && live) issue(u, 0);
  uint32_t parity = 0;  // bit s: the phase stage s waits on next
  for (int k = 0; u < a.units; u += gridDim.x, ++k) {
    const int s = k & 1;
    const int next = u + gridDim.x;
    const bool next_live = next < a.units && a.valid[unit_at(a, next).first];
    if (tid == 0) {
      // the stores of the unit before have read stage s^1 (bf16) and the
      // narrow tile (quantized)
      bulk_wait_read();
      if (next_live) issue(next, s ^ 1);
    }
    __syncthreads();
    if (live) {
      const Unit w = unit_at(a, u);
      const int pos = a.positions[w.first];
      const int page = a.page_tables[w.b * a.max_pages + pos / a.page_size];
      const long long dst_tok =
          ((long long)w.layer * a.num_pages + page) * a.page_size + pos % a.page_size;
      long long first;
      int n;
      span<T, D>(a, w, &first, &n);
      bar_wait(&bar[s], (parity >> s) & 1u);
      parity ^= 1u << s;
      if constexpr (!QUANT) {
        if (tid == 0) {
          const long long dst = dst_tok * a.row_vecs + (long long)w.chunk * UNIT_VECS;
          bulk_store(reinterpret_cast<uint4*>(a.k_cache) + dst, in[s][0], n * 16);
          bulk_store(reinterpret_cast<uint4*>(a.v_cache) + dst, in[s][1], n * 16);
          bulk_commit();
        }
      } else {
        constexpr int LPR = D / 8;                 // lanes a row
        constexpr int RPB = THREADS / LPR;         // rows the block covers at once
        constexpr int ROWS = UNIT_BYTES / (2 * D);
        const int sl = tid % LPR;
        const long long dst = dst_tok * a.hkv + (long long)w.chunk * ROWS;  // first row
#pragma unroll
        for (int r0 = 0; r0 < ROWS; r0 += RPB) {
          const int r = r0 + tid / LPR;
          const bool row_live = r < n;  // every lane joins the shuffles
          uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
          if (row_live) {
            kr = *reinterpret_cast<const uint4*>(in[s][0] + (r * D + sl * 8) * 2);
            vr = *reinterpret_cast<const uint4*>(in[s][1] + (r * D + sl * 8) * 2);
          }
          float ka = amax8(kr), va = amax8(vr);
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) {
            ka = fmaxf(ka, __shfl_xor_sync(0xffffffffu, ka, o));
            va = fmaxf(va, __shfl_xor_sync(0xffffffffu, va, o));
          }
          if (row_live) {
            const float ks = fmaxf(ka / kvq::Kv<T>::QMAX, 1e-8f);
            const float vs = fmaxf(va / kvq::Kv<T>::QMAX, 1e-8f);
            *reinterpret_cast<uint2*>(out[0] + r * D + sl * 8) = quantize8<T>(kr, ks);
            *reinterpret_cast<uint2*>(out[1] + r * D + sl * 8) = quantize8<T>(vr, vs);
            if (sl == 0) {
              a.k_scale[dst + r] = ks;
              a.v_scale[dst + r] = vs;
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (tid == 0) {
          bulk_store(reinterpret_cast<uint8_t*>(a.k_cache) + dst * D, out[0], n * D);
          bulk_store(reinterpret_cast<uint8_t*>(a.v_cache) + dst * D, out[1], n * D);
          bulk_commit();
        }
      }
    }
    __syncthreads();  // every thread is done with stage s before it is refilled
    live = next_live;
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T, int D>
int launch(Args a, cudaStream_t stream) {
  static std::atomic<int> slots_of[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int slots = slots_of[dev].load(std::memory_order_relaxed);
  if (slots == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, paged_write_bulk_kernel<T, D>,
                                                      THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (sms < 1 || per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots = sms * per_sm;
    slots_of[dev].store(slots, std::memory_order_relaxed);
  }
  paged_write_bulk_kernel<T, D><<<a.units < slots ? a.units : slots, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The signature of csrc/kv_update.cu's dyn_paged_write.
extern "C" int dyn_paged_write(const void* k_stage, const void* v_stage,
                               void* k_cache, void* v_cache, void* k_scale,
                               void* v_scale, const void* page_tables,
                               const void* positions, const void* valid, int kind,
                               int layers, int num_pages, int page_size, int batch,
                               int tokens, int max_pages, int run, int hkv, int d,
                               int row_bytes, void* stream) {
  if (run <= 0 || tokens % run != 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || tokens == 0 || layers == 0) return 0;
  Args a{(const __nv_bfloat16*)k_stage, (const __nv_bfloat16*)v_stage, k_cache, v_cache,
         (float*)k_scale, (float*)v_scale, (const int*)page_tables, (const int*)positions,
         (const unsigned char*)valid, num_pages, page_size, batch, tokens, max_pages, run,
         hkv, row_bytes / 16, tokens / run, batch * (tokens / run), 0, 0};
  if (kind == 0) {
    if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
    a.chunks = (int)(((long long)run * a.row_vecs + UNIT_VECS - 1) / UNIT_VECS);
  } else {
    if ((d != 64 && d != 128) || k_scale == nullptr || v_scale == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    const int rows = UNIT_BYTES / (2 * d);
    a.chunks = (run * hkv + rows - 1) / rows;
  }
  const long long units = (long long)layers * a.runs * a.chunks;
  if (units > INT_MAX / 2) return (int)cudaErrorInvalidValue;
  a.units = (int)units;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0) return launch<__nv_bfloat16, 0>(a, st);
  if (kind == 1) return d == 64 ? launch<int8_t, 64>(a, st) : launch<int8_t, 128>(a, st);
  if (kind == 2) {
    return d == 64 ? launch<__nv_fp8_e4m3, 64>(a, st) : launch<__nv_fp8_e4m3, 128>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}
