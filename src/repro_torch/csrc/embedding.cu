// Embedding-row gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding.py:gather
// (_gather_kernel): out[t] = table[ids[t]] for a (V, d) table and T ids.
//
// What bounds it on this card: it does no arithmetic; it reads T rows and
// writes T rows, so it is bound by bytes (3.35 TB/s): 2 MB each way for
// 256 rows of glm4_9b's 8 KB, under a microsecond. At serving sizes (8 to
// 256 rows) what it actually waits on is latency: the id's round trip to
// memory, then the row's.
//
// What this design does about it: each warp copies one 2 KB segment of a
// row (a 4096-wide bf16 row is four segments), so a 256-row chunk keeps
// 1024 warps on all SMs instead of 256 on a few. The warp reads its id
// once (one broadcast load), then each lane issues all four of its
// 16-byte loads (non-coherent, not kept in L1: a row is read once) before
// any store, so a segment costs one memory round trip after the id's.
// Only the touched rows move, as with the TPU kernel's scalar-prefetched
// ids. Ids follow jnp's indexing rule, as the reference table[ids] does
// off the TPU: a negative id counts from the end (id + V), then the row is
// clamped into [0, V), so a bad id can never read outside the table.
//
// Narrow rows. The dataflow core gathers float32 rows of 4 bytes (a 1-D
// vector), 8 bytes (the paper's Figure 3 table), or rows of a table seen
// through a view at an address that is not 16-byte aligned. Where the row
// bytes or an address rule out 16-byte vectors, gather_words_kernel
// copies 4-byte words instead: one thread a word of the output, so a
// warp covers 32 consecutive output words (16 two-word rows) with one
// coalesced store and reads each row's words together. The entry point
// chooses the path by row bytes and alignment; every model table keeps the
// vector path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;    // segments per block
constexpr int VPL = 4;      // 16-byte vectors per lane: 2 KB per segment
constexpr int SEG = 32 * VPL;

__device__ __forceinline__ uint4 ld_once(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// warp w copies segment w % nseg of row w / nseg
__global__ void __launch_bounds__(WARPS * 32)
gather_rows_kernel(const uint4* __restrict__ table,
                   const int* __restrict__ ids, uint4* __restrict__ out,
                   int T, int row_vecs, int nseg, int V) {
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int t = w / nseg;
  if (t >= T) return;
  const int c0 = (w - t * nseg) * SEG + lane;
  int id = __ldg(ids + t);
  id = min(max(id < 0 ? id + V : id, 0), V - 1);
  const uint4* src = table + (size_t)id * row_vecs;
  uint4* dst = out + (size_t)t * row_vecs;
  uint4 buf[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j)
    if (c0 + 32 * j < row_vecs) buf[j] = ld_once(src + c0 + 32 * j);
#pragma unroll
  for (int j = 0; j < VPL; ++j)
    if (c0 + 32 * j < row_vecs) dst[c0 + 32 * j] = buf[j];
}

// thread i copies word i % row_words of output row i / row_words
__global__ void __launch_bounds__(256)
gather_words_kernel(const uint32_t* __restrict__ table,
                    const int* __restrict__ ids, uint32_t* __restrict__ out,
                    long long total, int row_words, int V) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long t = i / row_words;
  const int c = (int)(i - t * row_words);
  int id = __ldg(ids + t);
  id = min(max(id < 0 ? id + V : id, 0), V - 1);
  out[i] = __ldg(table + (size_t)id * row_words + c);
}

}  // namespace

extern "C" {

// table (V, row_bytes), ids (T,) int32 -> out (T, row_bytes); row_bytes a
// multiple of 4 at 4-byte aligned addresses (16-byte vectors where the row
// bytes and both addresses allow). Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for rows the kernels do not take.
int embedding_gather(const void* table, const void* ids, void* out, int T,
                     int V, int row_bytes, void* stream) {
  if (T == 0) return static_cast<int>(cudaGetLastError());
  const uintptr_t addr = (uintptr_t)table | (uintptr_t)out;
  if (row_bytes % 4 || addr % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_bytes % 16 || addr % 16) {
    const int row_words = row_bytes / 4;
    const long long total = (long long)T * row_words;
    gather_words_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(table), static_cast<const int*>(ids),
        static_cast<uint32_t*>(out), total, row_words, V);
    return static_cast<int>(cudaGetLastError());
  }
  const int row_vecs = row_bytes / 16, nseg = (row_vecs + SEG - 1) / SEG;
  const long long warps = (long long)T * nseg;
  gather_rows_kernel<<<(unsigned)((warps + WARPS - 1) / WARPS), WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int*>(ids),
      static_cast<uint4*>(out), T, row_vecs, nseg, V);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
