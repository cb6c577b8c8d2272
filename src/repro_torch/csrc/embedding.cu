// Embedding-row gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding.py:gather
// (_gather_kernel): out[t] = table[ids[t]] for a (V, d) table and T ids.
//
// What bounds it on this card: it does no arithmetic; it reads T rows and
// writes T rows, so it is bound by bytes (3.35 TB/s), and at serving sizes
// (a few hundred rows of 8 KB) by launch latency.
//
// What this design does about it: one thread block per id copies its row
// with 16-byte vector loads and stores, neighbouring threads on
// neighbouring addresses (d = 4096 bf16 -> 512 uint4, one per thread).
// Only the touched rows move, as with the TPU kernel's scalar-prefetched
// ids. Ids are clamped into [0, V) (the model clamps them before the call
// already), so a bad id can never read outside the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_kernel(const uint4* __restrict__ table,
                                   const int* __restrict__ ids,
                                   uint4* __restrict__ out, int row_vecs,
                                   int V) {
  const int t = blockIdx.x;
  const int id = min(max(ids[t], 0), V - 1);
  const uint4* src = table + (size_t)id * row_vecs;
  uint4* dst = out + (size_t)t * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

extern "C" {

// table (V, row_bytes), ids (T,) int32 -> out (T, row_bytes); row_bytes a
// multiple of 16. Returns cudaGetLastError() after the launch.
int embedding_gather(const void* table, const void* ids, void* out, int T,
                     int V, int row_bytes, void* stream) {
  if (T == 0) return static_cast<int>(cudaGetLastError());
  const int row_vecs = row_bytes / 16;
  int threads = row_vecs < 512 ? row_vecs : 512;
  threads = (threads + 31) / 32 * 32;
  gather_rows_kernel<<<T, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int*>(ids),
      static_cast<uint4*>(out), row_vecs, V);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
