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
// a quantized pool D narrow bytes and a 4-byte scale out. A run is min(T,
// S) slots of one (sequence, page), placed by its first token; its rows
// are contiguous in the stage, the pool and the scale plane alike.
//
// Design. A copy at the memory's rate needs about 18 KB of loads in
// flight on each SM (3.35 TB/s times about 0.7 us), and a small call
// must not wait on a chain of dependent loads.
// - Work units and a grid from the card. Each (layer, run) is cut into
//   units of a fixed size, so a B=1 chunk spreads over every SM and a
//   decode row stays one unit: 512 16-byte vectors of K and as many of V
//   (8 KB each) for a bf16 pool, 32 (token, kv head) rows of K and of V
//   (4 KB each at D=64, 6 KB at D=96, 8 KB at D=128, 16 KB at D=256) for a
//   quantized one. The launch is
//   min(units, resident blocks x SMs) blocks of 128 threads
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor, once per device),
//   each walking the units with a stride of the grid. The grid comes from
//   B, T, L, Hkv, D and the card, never from the data: no host sync, no
//   workspace, and a call replays in a CUDA graph.
// - Bytes in flight. Each thread issues all of its unit's 16-byte loads of
//   K and of V before it needs any of them (4 + 4 for a bf16 pool, LPR/4 +
//   LPR/4 for a quantized one), and 8 or 9 blocks fit a SM at D=64.
// - A short index chain. A unit reads its run's `valid` and `positions`
//   entries together, then, for a live run, its rows and the page-table
//   entry (which depends on `positions`), so a unit waits on two round
//   trips before its stores, not the four of valid, positions, page
//   table, rows. A padding unit costs its two index loads.
// - A quantized pool gives each (token, kv head) row LPR lanes, D/8
//   rounded up to a power of two (8 at D=64, 16 at D=96 and 128, 32 at
//   D=256), each holding 8 values; a D=96 row's last 4 lanes load zeros
//   and store nothing, so every row's xor-shuffle tree stays within its
//   own aligned group of lanes. The row's lanes reduce the amaxes of all
//   of a lane's K and V rows in one pass of shuffles, so K and V cost one
//   round trip, and a row past the run skips its divisions. The
//   quantization is the reference's to the bit: scale = max(amax / qmax,
//   1e-8) and x / scale by IEEE division (no reciprocal, no fast math),
//   rounded half to even for int8 and saturated round to nearest for e4m3.
// Registers (ptxas, CUDA 12.8, sm_90a): 56 for a bf16 pool; quantized 58
// at D=64, 96 at D=96, 95 at D=128, 168 at D=256 (with 4 bytes of spill
// stores and loads, the only instance that spills).
// A run whose first token is padding belongs to no sequence: the Pallas
// kernel sends it to the null page 0, whose contents are unspecified and
// which no page table names, so this kernel skips it and moves no bytes
// for it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "kv_quant.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// 16-byte vectors of K, and as many of V, a thread loads per unit (bf16 pools)
constexpr int VECS = 4;
constexpr int UNIT_VECS = VECS * THREADS;
// (token, kv head) rows of a unit (quantized pools): 4 KB of K at D=64
constexpr int UNIT_ROWS = 32;

// the lanes a quantized row of D values takes: D/8, rounded up to a power
// of two so that the row's shuffle tree stays within its lanes
__host__ __device__ constexpr int lanes_per_row(int d) {
  int n = 1;
  while (n < d / 8) n *= 2;
  return n;
}

// devices whose resident-block count is cached
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

// Unit u: chunk `chunk` of run r of layer `layer`; the run starts at
// [B, T] index `first` of sequence b.
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

// A lane's 8 values of one row, quantized against the row's amax; the
// row's first lane also lands the scale.
template <typename T>
__device__ __forceinline__ void quantize_store(uint4 raw, float amax, uint8_t* q, float* scale,
                                               bool lead) {
  const float s = fmaxf(amax / kvq::Kv<T>::QMAX, 1e-8f);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    packed[j / 2] |= (kvq::Kv<T>::encode(v.x / s) | kvq::Kv<T>::encode(v.y / s) << 8)
                     << (16 * (j % 2));
  }
  *reinterpret_cast<uint2*>(q) = make_uint2(packed[0], packed[1]);
  if (lead) *scale = s;
}

// One live unit at `pos`: its rows' loads, then the page-table read, then
// the stores. D is the head dim of a quantized pool (0 for a bf16 pool).
template <typename T, int D>
__device__ __forceinline__ void write_unit(const Args& a, const Unit& w, int pos) {
  const long long src_row = (long long)w.layer * a.batch * a.tokens + w.first;  // token rows
  if constexpr (!kvq::Kv<T>::QUANT) {
    const long long n = (long long)a.run * a.row_vecs;  // vectors of the run
    const int base = w.chunk * UNIT_VECS + threadIdx.x;
    const uint4* ks = reinterpret_cast<const uint4*>(a.k_stage) + src_row * a.row_vecs;
    const uint4* vs = reinterpret_cast<const uint4*>(a.v_stage) + src_row * a.row_vecs;
    uint4 kr[VECS], vr[VECS];
#pragma unroll
    for (int j = 0; j < VECS; ++j) {
      if (base + j * THREADS < n) {
        kr[j] = __ldg(ks + base + j * THREADS);
        vr[j] = __ldg(vs + base + j * THREADS);
      }
    }
    const int page = __ldg(a.page_tables + w.b * a.max_pages + pos / a.page_size);
    const long long dst_row =
        ((long long)w.layer * a.num_pages + page) * a.page_size + pos % a.page_size;
    uint4* kc = reinterpret_cast<uint4*>(a.k_cache) + dst_row * a.row_vecs;
    uint4* vc = reinterpret_cast<uint4*>(a.v_cache) + dst_row * a.row_vecs;
#pragma unroll
    for (int j = 0; j < VECS; ++j) {
      if (base + j * THREADS < n) {
        kc[base + j * THREADS] = kr[j];
        vc[base + j * THREADS] = vr[j];
      }
    }
  } else {
    constexpr int LPR = lanes_per_row(D);  // lanes a row
    constexpr int RPW = 32 / LPR;         // rows a warp covers at once
    constexpr int RPB = RPW * WARPS;      // rows the block covers at once
    constexpr int ROWS = UNIT_ROWS / RPB;  // rows of K, and of V, a lane holds
    static_assert(D % 16 == 0 && LPR <= 32 && UNIT_ROWS % RPB == 0, "row map");
    const int lane = threadIdx.x % 32;
    const int sl = lane % LPR;
    const bool holds = sl < D / 8;        // false for a D=96 row's last 4 lanes
    const int n = a.run * a.hkv;          // (token, kv head) rows of the run
    const int base = w.chunk * UNIT_ROWS + (threadIdx.x / 32) * RPW + lane / LPR;
    const long long src = (src_row * a.hkv + base) * D + sl * 8;  // this lane's first values
    uint4 kr[ROWS], vr[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      kr[j] = vr[j] = make_uint4(0, 0, 0, 0);  // every lane joins the shuffles
      if (holds && base + j * RPB < n) {
        kr[j] = __ldg(reinterpret_cast<const uint4*>(a.k_stage + src + j * RPB * D));
        vr[j] = __ldg(reinterpret_cast<const uint4*>(a.v_stage + src + j * RPB * D));
      }
    }
    const int page = __ldg(a.page_tables + w.b * a.max_pages + pos / a.page_size);
    float ka[ROWS], va[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      ka[j] = amax8(kr[j]);
      va[j] = amax8(vr[j]);
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        ka[j] = fmaxf(ka[j], __shfl_xor_sync(0xffffffffu, ka[j], o));
        va[j] = fmaxf(va[j], __shfl_xor_sync(0xffffffffu, va[j], o));
      }
    }
    // this lane's first row in the pool and its plane
    const long long dst =
        (((long long)w.layer * a.num_pages + page) * a.page_size + pos % a.page_size) * a.hkv +
        base;
    uint8_t* kq = reinterpret_cast<uint8_t*>(a.k_cache) + dst * D + sl * 8;
    uint8_t* vq = reinterpret_cast<uint8_t*>(a.v_cache) + dst * D + sl * 8;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      // a row past the run skips its divisions: at decode most rows of a
      // unit are (8 of its 32 are live at Hkv=8)
      if (holds && base + j * RPB < n) {
        quantize_store<T>(kr[j], ka[j], kq + j * RPB * D, a.k_scale + dst + j * RPB, sl == 0);
        quantize_store<T>(vr[j], va[j], vq + j * RPB * D, a.v_scale + dst + j * RPB, sl == 0);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) paged_write_kernel(const Args a) {
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const Unit w = unit_at(a, u);
    const bool live = __ldg(a.valid + w.first);
    const int pos = __ldg(a.positions + w.first);  // beside `valid`
    if (live) write_unit<T, D>(a, w, pos);          // uniform across the block
  }
}

template <typename T, int D>
int launch(Args a, cudaStream_t stream) {
  // resident blocks a SM times SMs, per device: a property of the kernel
  // and the card, read once
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, paged_write_kernel<T, D>,
                                                      THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (sms < 1 || per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots = sms * per_sm;
    slots_of[dev].store(slots, std::memory_order_relaxed);
  }
  paged_write_kernel<T, D><<<a.units < slots ? a.units : slots, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// a quantized pool's launch for its head dim
template <typename T>
int launch_d(int d, Args a, cudaStream_t stream) {
  if (d == 64) return launch<T, 64>(a, stream);
  if (d == 96) return launch<T, 96>(a, stream);
  if (d == 128) return launch<T, 128>(a, stream);
  if (d == 256) return launch<T, 256>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// kind: 0 a pool of the staged dtype (bf16 on the model path; its token
// rows of row_bytes are copied), 1 int8, 2 fp8 (e4m3); the scale planes
// are null for 0. A quantized pool takes D 64, 96, 128 or 256.
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
    if ((d != 64 && d != 96 && d != 128 && d != 256) || k_scale == nullptr ||
        v_scale == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    a.chunks = (int)(((long long)run * hkv + UNIT_ROWS - 1) / UNIT_ROWS);
  }
  const long long units = (long long)layers * a.runs * a.chunks;
  if (units > INT_MAX / 2) return (int)cudaErrorInvalidValue;  // u + grid stays an int
  a.units = (int)units;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0) return launch<__nv_bfloat16, 0>(a, st);
  if (kind == 1) return launch_d<int8_t>(d, a, st);
  if (kind == 2) return launch_d<__nv_fp8_e4m3>(d, a, st);
  return (int)cudaErrorInvalidValue;
}
