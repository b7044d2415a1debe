// Paged KV write for Hopper (sm_90a).
//
// Replaces: dynamo_tpu/ops/kv_update.py::paged_write, the Pallas kernel
// _write_kernel (pallas_call at kv_update.py:266), which issues one DMA
// per (sequence, page-run) covering every layer.
//
// Bound on the H100: bytes. The write moves each run that lands in a
// real page once in and once out (4 * L * rows * Hkv*D*itemsize bytes,
// rows = run * the runs whose first token is valid) and does no
// arithmetic.
// Design: one block per (run, layer), so a prefill chunk spreads over
// L * B * T/run blocks and a decode step over L * B. Each token row
// (Hkv*D elements, contiguous in both layouts) moves as 16-byte vectors,
// neighbouring threads on neighbouring addresses. A run whose first
// token is padding belongs to no sequence: the Pallas kernel sends it to
// the null page 0, whose contents are unspecified and which no page
// table names, so this kernel skips it and moves no bytes for it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(128) paged_write_kernel(
    const uint4* __restrict__ k_stage,    // [L, B, T, row_vecs]
    const uint4* __restrict__ v_stage,
    uint4* __restrict__ k_cache,          // [L, P, S, row_vecs]
    uint4* __restrict__ v_cache,
    const int* __restrict__ page_tables,  // [B, MP]
    const int* __restrict__ positions,    // [B, T]
    const unsigned char* __restrict__ valid,  // [B, T] bool
    int num_pages, int page_size, int batch, int tokens, int max_pages,
    int run, int row_vecs) {
  const int runs_per_seq = tokens / run;
  const int r = blockIdx.x;
  const int layer = blockIdx.y;
  const int b = r / runs_per_seq;
  const int first = b * tokens + (r % runs_per_seq) * run;  // [B, T] index
  if (!valid[first]) return;  // a padding run: nothing to land
  const int pos = positions[first];
  const int page = page_tables[b * max_pages + pos / page_size];
  const int slot0 = pos % page_size;
  const long long src = ((long long)layer * batch * tokens + first) * row_vecs;
  const long long dst =
      (((long long)layer * num_pages + page) * page_size + slot0) * row_vecs;
  const long long n = (long long)run * row_vecs;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    k_cache[dst + i] = k_stage[src + i];
    v_cache[dst + i] = v_stage[src + i];
  }
}

}  // namespace

extern "C" int dyn_paged_write(const void* k_stage, const void* v_stage,
                               void* k_cache, void* v_cache,
                               const void* page_tables, const void* positions,
                               const void* valid, int layers, int num_pages,
                               int page_size, int batch, int tokens,
                               int max_pages, int run, int row_bytes,
                               void* stream) {
  if (run <= 0 || tokens % run != 0 || row_bytes % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(batch * (tokens / run), layers);
  paged_write_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const uint4*)k_stage, (const uint4*)v_stage, (uint4*)k_cache,
      (uint4*)v_cache, (const int*)page_tables, (const int*)positions,
      (const unsigned char*)valid, num_pages, page_size, batch, tokens,
      max_pages, run, row_bytes / 16);
  return (int)cudaGetLastError();
}
