// Paged decode and chunked-prefill attention for Hopper (sm_90a): the C
// entry points over the kernel in paged_attention.cuh, which says what it
// replaces, what bounds it and how it is laid out.
//
// Pools are bf16 (pool_type 0) with null scale pointers, or int8 (1) / fp8
// e4m3 (2) with fp32 (num_blocks, block_size, K, 1) scale pools, whose
// rows the kernel dequantizes in-tile. cap <= 0: no softcap; window <= 0:
// no sliding window. Each function returns cudaGetLastError() after the
// launch.

#include "paged_attention.cuh"

namespace {

paged::Args make_args(const void* q, void* k_pages, void* v_pages,
                      const void* k_scale, const void* v_scale,
                      const void* block_tables, const void* ctx_lens,
                      const void* q_lens, void* out, int C, int H, int K,
                      int bs, int nb, float scale, float cap, int window) {
  paged::Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.block_tables = static_cast<const int*>(block_tables);
  a.ctx_lens = static_cast<const int*>(ctx_lens);
  a.q_lens = static_cast<const int*>(q_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
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

}  // namespace

extern "C" {

// Decode: q (B, H, hd) -> out (B, H, hd).
int paged_decode(const void* q, void* k_pages, void* v_pages,
                 const void* k_scale, const void* v_scale,
                 const void* block_tables, const void* ctx_lens, void* out,
                 int B, int H, int K, int hd, int bs, int nb, int pool_type,
                 float scale, float cap, int window, void* stream) {
  const paged::Args a =
      make_args(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                ctx_lens, nullptr, out, 1, H, K, bs, nb, scale, cap, window);
  return paged::launch<paged::kChunk>(a, B, H / K, hd, pool_type, stream);
}

// Chunked prefill: q (B, C, H, hd) + q_lens (B,) -> out (B, C, H, hd).
int paged_prefill(const void* q, void* k_pages, void* v_pages,
                  const void* k_scale, const void* v_scale,
                  const void* block_tables, const void* ctx_lens,
                  const void* q_lens, void* out, int B, int C, int H, int K,
                  int hd, int bs, int nb, int pool_type, float scale,
                  float cap, int window, void* stream) {
  const paged::Args a =
      make_args(q, k_pages, v_pages, k_scale, v_scale, block_tables,
                ctx_lens, q_lens, out, C, H, K, bs, nb, scale, cap, window);
  return paged::launch<paged::kChunk>(a, B, C * (H / K), hd, pool_type,
                                      stream);
}

}  // extern "C"
