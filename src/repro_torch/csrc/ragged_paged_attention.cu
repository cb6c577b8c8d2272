// Packed (ragged) chunked-prefill attention for Hopper (sm_90a), with an
// optional fused KV write: the C entry point over the kernel in
// paged_attention.cuh, which says what it replaces, what bounds it and
// how the fused write avoids racing the blocks that read the pages.
//
// q (T, H, hd) bf16: chunks of S sequences packed back to back, sequence s
// owning flat rows [starts[s], ends[s]) (starts == ends: an unused pack
// slot). Block tables (S, nb), ctx_lens (S,). out (T, H, hd) must be
// zero-filled by the caller: rows that no sequence owns are not written.
// With k_new/v_new ((T, K, hd) in the pool dtype) each sequence's chunk
// rows are also stored into its pages, in place. Pool types and scale
// pools as in paged_attention.cu. Returns cudaGetLastError() after the
// launch.

#include "paged_attention.cuh"

extern "C" {

int ragged_paged_prefill(const void* q, void* k_pages, void* v_pages,
                         const void* k_scale, const void* v_scale,
                         const void* k_new, const void* v_new,
                         const void* block_tables, const void* ctx_lens,
                         const void* starts, const void* ends, void* out,
                         int T, int S, int H, int K, int hd, int bs, int nb,
                         int pool_type, float scale, float cap, int window,
                         void* stream) {
  paged::Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.k_new = k_new;
  a.v_new = v_new;
  a.block_tables = static_cast<const int*>(block_tables);
  a.ctx_lens = static_cast<const int*>(ctx_lens);
  a.starts = static_cast<const int*>(starts);
  a.ends = static_cast<const int*>(ends);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.C = T;
  a.H = H;
  a.K = K;
  a.bs = bs;
  a.nb = nb;
  a.scale = scale;
  a.cap = cap;
  a.window = window;
  const int rows = T * (H / K);      // the most rows one sequence can own
  if ((k_new == nullptr) != (v_new == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k_new != nullptr)
    return paged::launch<paged::kRaggedWrite>(a, S, rows, hd, pool_type,
                                              stream);
  return paged::launch<paged::kRagged>(a, S, rows, hd, pool_type, stream);
}

}  // extern "C"
