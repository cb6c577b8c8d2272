// Paged decode and chunked-prefill attention for Hopper (sm_90a): the C
// entry points over the kernel in paged_attention.cuh, which says what it
// replaces, what bounds it and how it is laid out. Decode runs in two
// launches (the segments' partials, then their merge) through a scratch
// tensor the caller allocates; a 1-row chunk gives the same bits.
//
// Pools are bf16 (pool_type 0) with null scale pointers, or int8 (1) / fp8
// e4m3 (2) with fp32 (num_blocks, block_size, K, 1) scale pools, whose
// rows the kernel dequantizes in-tile. cap <= 0: no softcap; window <= 0:
// no sliding window. Each function returns cudaGetLastError() after the
// launch.
//
// The partials of pool-sharded serving (the TPU kernels' block_mask and
// return_lse): block_mask, when not null, is int32 (n_seqs, nb), and the
// keys of a zero entry are neither read nor attended. With lse not null,
// out is fp32 (the locally normalized output) and lse (rows, H) fp32 gets
// m + log(l) per (row, head), -1e30 where a row attended nothing; the
// arithmetic is the same as for a bf16 out, so out rounded to bf16 equals
// the bf16 launch's bytes.

#include "paged_attention.cuh"

namespace {

paged::Args make_args(const void* q, void* k_pages, void* v_pages,
                      const void* k_scale, const void* v_scale,
                      const void* block_tables, const void* ctx_lens,
                      const void* q_lens, const void* block_mask, void* out,
                      void* lse, int C, int H, int K, int bs, int nb,
                      float scale, float cap, int window) {
  paged::Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.block_tables = static_cast<const int*>(block_tables);
  a.ctx_lens = static_cast<const int*>(ctx_lens);
  a.q_lens = static_cast<const int*>(q_lens);
  a.block_mask = static_cast<const int*>(block_mask);
  if (lse != nullptr) {
    a.out32 = static_cast<float*>(out);
    a.lse = static_cast<float*>(lse);
  } else {
    a.out = static_cast<__nv_bfloat16*>(out);
  }
  a.C = C;
  a.H = H;
  a.K = K;
  a.bs = bs;
  a.nb = nb;
  a.scale = scale;
  a.cap = cap;
  a.window = window;
  return a;
}

// The property a skipped, fully masked step relies on: an mma.sync whose
// A rows are zero returns those rows of C unchanged. Warp w computes
// mma(C_w, A_w, B_w) with A_w's rows 0-7 zeroed (rows 8-15 as given);
// fragments in mma.cuh's per-lane order, 128 A, 64 B and 128 C words
// per warp.
__global__ void mma_zero_rows_kernel(const uint32_t* a, const uint32_t* b,
                                     const float* c, float* out, int warps) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= warps) return;
  uint32_t fa[4];
  float d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    fa[i] = (i == 1 || i == 3) ? a[w * 128 + i * 32 + lane] : 0u;
    d[i] = c[w * 128 + i * 32 + lane];
  }
  mma_bf16(d, fa, b[w * 64 + lane], b[w * 64 + 32 + lane]);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[w * 128 + i * 32 + lane] = d[i];
}

}  // namespace

extern "C" {

// The zero-row probe above over `warps` warps: out[w][i][lane] is
// accumulator register i of the lane (0, 1: row lane / 4, the zero
// rows; 2, 3: row lane / 4 + 8).
int paged_mma_zero_rows_probe(const void* a, const void* b, const void* c,
                              void* out, int warps, void* stream) {
  mma_zero_rows_kernel<<<(warps + 3) / 4, 128, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const float*>(c), static_cast<float*>(out), warps);
  return static_cast<int>(cudaGetLastError());
}

// fp32 scratch floats decode needs for its segments' partials: one per
// (sequence, kv head, 16-row tile, segment of the table's keys).
long long paged_decode_scratch_floats(int B, int H, int K, int hd, int bs,
                                      int nb) {
  const long long tiles = (H / K + paged::kDecodeRows - 1) /
                          paged::kDecodeRows;
  const long long nseg = ((long long)nb * bs + paged::kSeg - 1) / paged::kSeg;
  return (long long)B * K * tiles * nseg * paged::part_floats(hd);
}

// Decode: q (B, H, hd) -> out (B, H, hd), through `part` (fp32 scratch of
// paged_decode_scratch_floats floats, `part_floats` given); block_mask
// and lse may be null (see above).
int paged_decode(const void* q, void* k_pages, void* v_pages,
                 const void* k_scale, const void* v_scale,
                 const void* block_tables, const void* ctx_lens,
                 const void* block_mask, void* out, void* lse,
                 void* part, long long part_floats, int B, int H, int K,
                 int hd, int bs, int nb, int pool_type, float scale,
                 float cap, int window, void* stream) {
  if (part_floats < paged_decode_scratch_floats(B, H, K, hd, bs, nb))
    return static_cast<int>(cudaErrorInvalidValue);
  paged::Args a =
      make_args(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                ctx_lens, nullptr, block_mask, out, lse, 1, H, K, bs, nb,
                scale, cap, window);
  a.part = static_cast<float*>(part);
  a.nseg = (nb * bs + paged::kSeg - 1) / paged::kSeg;
  return paged::launch<paged::kDecode>(a, B, H / K, hd, pool_type, stream);
}

// Chunked prefill: q (B, C, H, hd) + q_lens (B,) -> out (B, C, H, hd);
// block_mask and lse ((B, C, H)) may be null.
int paged_prefill(const void* q, void* k_pages, void* v_pages,
                  const void* k_scale, const void* v_scale,
                  const void* block_tables, const void* ctx_lens,
                  const void* q_lens, const void* block_mask, void* out,
                  void* lse, int B, int C, int H, int K,
                  int hd, int bs, int nb, int pool_type, float scale,
                  float cap, int window, void* stream) {
  const paged::Args a =
      make_args(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                ctx_lens, q_lens, block_mask, out, lse, C, H, K, bs, nb,
                scale, cap, window);
  return paged::launch<paged::kChunk>(a, B, C * (H / K), hd, pool_type,
                                      stream);
}

}  // extern "C"
