// Paged attention for Hopper (sm_90a): decode and chunked prefill.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_decode            <- paged_attention          (_decode_kernel)
//   paged_prefill           <- paged_prefill_attention  (_chunk_kernel)
// Both C entry points run one templated kernel; decode is the chunk kernel
// with C = 1 and q_len = 1, so a 1-row chunk reproduces a decode step bit
// for bit.
//
// Semantics (same as the TPU kernels): q (B, C, H, hd) bf16, page pools
// (num_blocks, block_size, K, hd) bf16, block tables (B, nb) int32, ctx
// (B,) int32 visible tokens including the chunk, q_lens (B,) int32 valid
// chunk rows. Row i of sequence b sits at absolute position
// ctx - q_len + i and attends causally to keys [0, position] (and only the
// last `window` of them with a sliding window). GQA is g-major: q head h
// reads kv head h % K. Rows past q_len and sequences with ctx == 0 produce
// exact zeros. Output (B, C, H, hd) bf16.
//
// What bounds it on this card: decode reads every live KV page once and
// does 4 flops per KV element and query head, so at glm4's G = 16 query
// heads per kv head it is bound by bytes (3.35 TB/s). A 256-row prefill
// chunk reuses each page for 4096 query rows and is bound by operations.
//
// What this design does about it (first, simple version):
//  * one thread block owns one (sequence, kv head, tile of up to ROWS of
//    the C*G query rows); it walks the block table in order and skips dead
//    pages with the TPU kernels' liveness tests (past ctx; wholly before
//    the earliest in-window key) plus a tile-level causal cut (pages past
//    the tile's last row position), which only drops pages whose every
//    score the row mask would zero;
//  * each live page is loaded into shared memory once, with 16-byte loads,
//    for all G query heads of its kv head: the GQA reuse the TPU kernel
//    gets from computing a (G, hd) block per program;
//  * the next page's K and V are loaded into registers while the current
//    page is computed, hiding the global-memory latency of the page walk;
//  * scores, the online softmax (with the masked-row guard) and the
//    p @ v accumulation run in fp32 on the CUDA cores, each in a fixed
//    order per row, so a row's result depends only on its own query and
//    its sequence's keys: not on C, B or the row tile.
// No split over the KV axis: it would change the reduction order. At
// glm4's K = 2 and B = 8 a decode launch has 16 blocks on 132 SMs; the
// tensor cores are not used. Both are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBs = 32;           // largest block_size the kernel takes
constexpr float kNegInf = -1.0e30f;

template <int HD, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pages,
                       const __nv_bfloat16* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ ctx_lens,
                       const int* __restrict__ q_lens,   // null: decode
                       __nv_bfloat16* __restrict__ out,
                       int C, int H, int K, int bs, int nb, int n_tiles,
                       float scale, float cap, int window) {
  constexpr int QS = HD + 2;         // padded bf16 row: odd word stride
  constexpr int VEC = HD / 8;        // 16-byte vectors per row
  constexpr int EPT = ROWS * HD / kThreads;     // acc elements per thread
  constexpr int NV = (kMaxBs * VEC + kThreads - 1) / kThreads;

  __shared__ __align__(16) __nv_bfloat16 q_s[ROWS][QS];
  __shared__ __align__(16) __nv_bfloat16 k_s[kMaxBs][QS];
  __shared__ __align__(16) __nv_bfloat16 v_s[kMaxBs][HD];
  __shared__ float p_s[ROWS][kMaxBs + 1];
  __shared__ unsigned char ok_s[ROWS][kMaxBs];
  __shared__ float m_s[ROWS], l_s[ROWS], corr_s[ROWS];

  const int tid = threadIdx.x;
  int bid = blockIdx.x;
  const int tile = bid % n_tiles;
  bid /= n_tiles;
  const int kh = bid % K;
  const int b = bid / K;
  const int G = H / K;
  const int rows_total = C * G;
  const int r0 = tile * ROWS;

  const int ctx = ctx_lens[b];
  const int qlen = q_lens ? q_lens[b] : 1;
  const int qstart = ctx - qlen;     // absolute position of chunk row 0

  // query tile -> shared memory (zeros past the last row)
  for (int i = tid; i < ROWS * VEC; i += kThreads) {
    const int r = i / VEC, c8 = i % VEC, rr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rr < rows_total) {
      const int c = rr / G, g = rr % G;
      val = reinterpret_cast<const uint4*>(
          q + ((size_t)(b * C + c) * H + g * K + kh) * HD)[c8];
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(&q_s[r][c8 * 8]);
    dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
  }
  if (tid < ROWS) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // live page range [jlo, jhi): the TPU kernels' tests, in closed form
  int jhi = min(nb, (ctx + bs - 1) / bs);          // pages with j*bs < ctx
  const int c_lo = r0 / G;
  const int c_hi = (min(rows_total, r0 + ROWS) - 1) / G;
  const int last_c = min(c_hi, qlen - 1);
  if (c_lo >= qlen || qstart + last_c < 0) {
    jhi = 0;                          // the whole tile is padding rows
  } else {
    jhi = min(jhi, (qstart + last_c) / bs + 1);    // tile-level causal cut
  }
  int jlo = 0;
  if (window > 0) {
    while (jlo < jhi && jlo * bs + bs - 1 <= qstart - window) ++jlo;
  }

  float acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = 0.f;

  uint4 kreg[NV], vreg[NV];
  auto load_page = [&](int j) {
    const int page = block_tables[b * nb + j];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < bs * VEC) {
        const int t = idx / VEC, c8 = idx % VEC;
        const size_t off = ((size_t)(page * bs + t) * K + kh) * HD;
        kreg[i] = reinterpret_cast<const uint4*>(k_pages + off)[c8];
        vreg[i] = reinterpret_cast<const uint4*>(v_pages + off)[c8];
      }
    }
  };
  if (jlo < jhi) load_page(jlo);

  for (int j = jlo; j < jhi; ++j) {
    __syncthreads();                  // previous page fully consumed
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < bs * VEC) {
        const int t = idx / VEC, c8 = idx % VEC;
        uint32_t* kd = reinterpret_cast<uint32_t*>(&k_s[t][c8 * 8]);
        kd[0] = kreg[i].x; kd[1] = kreg[i].y;
        kd[2] = kreg[i].z; kd[3] = kreg[i].w;
        reinterpret_cast<uint4*>(&v_s[t][0])[c8] = vreg[i];
      }
    }
    __syncthreads();
    if (j + 1 < jhi) load_page(j + 1);  // in flight while this page computes

    // scores: s = (q . k) * scale -> softcap -> mask
    const int first_k = j * bs;
    for (int idx = tid; idx < ROWS * bs; idx += kThreads) {
      const int r = idx / bs, t = idx % bs, rr = r0 + r;
      const int c = rr / G;
      const int qpos = qstart + c;
      const int kpos = first_k + t;
      bool ok = rr < rows_total && c < qlen && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      float s = 0.f;
      const __nv_bfloat162* qv =
          reinterpret_cast<const __nv_bfloat162*>(&q_s[r][0]);
      const __nv_bfloat162* kv =
          reinterpret_cast<const __nv_bfloat162*>(&k_s[t][0]);
#pragma unroll 8
      for (int d = 0; d < HD / 2; ++d) {
        const float2 a = __bfloat1622float2(qv[d]);
        const float2 k2 = __bfloat1622float2(kv[d]);
        s = fmaf(a.x, k2.x, s);
        s = fmaf(a.y, k2.y, s);
      }
      s *= scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      p_s[r][t] = ok ? s : kNegInf;
      ok_s[r][t] = ok;
    }
    __syncthreads();

    // online softmax, one thread per row, with the masked-row guard
    if (tid < ROWS) {
      const int r = tid;
      const float m_prev = m_s[r];
      float mx = kNegInf;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, p_s[r][t]);
      const float m_new = fmaxf(m_prev, mx);
      float lsum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = ok_s[r][t] ? expf(p_s[r][t] - m_new) : 0.f;
        p_s[r][t] = p;
        lsum += p;
      }
      const float corr = expf(m_prev - m_new);
      l_s[r] = l_s[r] * corr + lsum;
      m_s[r] = m_new;
      corr_s[r] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p @ v
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / HD, d = e % HD;
      float t_sum = 0.f;
      for (int t = 0; t < bs; ++t)
        t_sum = fmaf(p_s[r][t], __bfloat162float(v_s[t][d]), t_sum);
      acc[i] = acc[i] * corr_s[r] + t_sum;
    }
  }
  __syncthreads();

  // finalize: acc / max(l, 1e-37) -> bf16, back to the (B, C, H, hd) layout
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / HD, d = e % HD, rr = r0 + r;
    if (rr < rows_total) {
      const int c = rr / G, g = rr % G;
      const float l = fmaxf(l_s[r], 1e-37f);
      out[((size_t)(b * C + c) * H + g * K + kh) * HD + d] =
          __float2bfloat16_rn(acc[i] / l);
    }
  }
}

template <int HD, int ROWS>
void launch_rows(const void* q, const void* kp, const void* vp,
                 const void* bt, const void* ctx, const void* qlens,
                 void* out, int B, int C, int H, int K, int bs, int nb,
                 float scale, float cap, int window, cudaStream_t stream) {
  const int rows_total = C * (H / K);
  const int n_tiles = (rows_total + ROWS - 1) / ROWS;
  const dim3 grid((unsigned)(B * K * n_tiles));
  paged_attention_kernel<HD, ROWS><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(ctx), static_cast<const int*>(qlens),
      static_cast<__nv_bfloat16*>(out), C, H, K, bs, nb, n_tiles, scale,
      cap, window);
}

template <int HD>
void launch_hd(const void* q, const void* kp, const void* vp,
               const void* bt, const void* ctx, const void* qlens, void* out,
               int B, int C, int H, int K, int bs, int nb, float scale,
               float cap, int window, cudaStream_t stream) {
  // the row tile only sets how many rows share a page load; no row's
  // arithmetic depends on it
  if (C * (H / K) <= 16)
    launch_rows<HD, 16>(q, kp, vp, bt, ctx, qlens, out, B, C, H, K, bs, nb,
                        scale, cap, window, stream);
  else
    launch_rows<HD, 64>(q, kp, vp, bt, ctx, qlens, out, B, C, H, K, bs, nb,
                        scale, cap, window, stream);
}

int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* ctx, const void* qlens, void* out, int B, int C,
           int H, int K, int hd, int bs, int nb, float scale, float cap,
           int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  switch (hd) {                       // glm4_9b: 128; its smoke size: 16
    case 16:
      launch_hd<16>(q, kp, vp, bt, ctx, qlens, out, B, C, H, K, bs, nb,
                    scale, cap, window, s);
      break;
    case 128:
      launch_hd<128>(q, kp, vp, bt, ctx, qlens, out, B, C, H, K, bs, nb,
                     scale, cap, window, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Decode: q (B, H, hd) -> out (B, H, hd). cap <= 0: no softcap; window
// <= 0: no sliding window. Returns cudaGetLastError() after the launch.
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const void* block_tables, const void* ctx_lens, void* out,
                 int B, int H, int K, int hd, int bs, int nb, float scale,
                 float cap, int window, void* stream) {
  return launch(q, k_pages, v_pages, block_tables, ctx_lens, nullptr, out,
                B, 1, H, K, hd, bs, nb, scale, cap, window, stream);
}

// Chunked prefill: q (B, C, H, hd) + q_lens (B,) -> out (B, C, H, hd).
int paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                  const void* block_tables, const void* ctx_lens,
                  const void* q_lens, void* out, int B, int C, int H, int K,
                  int hd, int bs, int nb, float scale, float cap, int window,
                  void* stream) {
  return launch(q, k_pages, v_pages, block_tables, ctx_lens, q_lens, out, B,
                C, H, K, hd, bs, nb, scale, cap, window, stream);
}

}  // extern "C"
