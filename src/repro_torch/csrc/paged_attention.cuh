// Paged attention for Hopper (sm_90a): one templated kernel behind the
// decode, chunked-prefill and packed (ragged) prefill entry points of
// paged_attention.cu and ragged_paged_attention.cu.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_decode             <- paged_attention                (_decode_kernel)
//   paged_prefill            <- paged_prefill_attention        (_chunk_kernel)
//   ragged_paged_prefill     <- ragged_paged_prefill_attention (_ragged_kernel)
// Decode is the chunk kernel with C = 1 and q_len = 1, and a packed
// sequence is a chunk whose rows start at a flat offset, so a row's bits
// do not depend on the entry point: a 1-row chunk reproduces a decode step,
// and each packed sequence's rows reproduce an unpacked chunk launch.
//
// Semantics (same as the TPU kernels): q bf16 with H heads of hd values
// per row; page pools (num_blocks, block_size, K, hd) of bf16, int8 or
// fp8 e4m3; block tables (n_seqs, nb) int32; ctx (n_seqs,) int32 visible
// tokens including the chunk. A sequence's chunk row i sits at absolute
// position ctx - q_len + i and attends causally to keys [0, position]
// (and only the last `window` of them with a sliding window). GQA is
// g-major: q head h reads kv head h % K. Chunk rows past q_len and
// sequences with ctx == 0 produce exact zeros.
//   chunk:  q (B, C, H, hd), q_lens (B,); sequence b owns rows b*C + i.
//   ragged: q (T, H, hd), starts/ends (S,); sequence s owns flat rows
//           [starts[s], ends[s]), q_len = ends - starts. Rows no sequence
//           owns are not touched (the wrapper zero-fills the output).
// Quantized pools carry fp32 per-row scales (num_blocks, block_size, K, 1):
// every key and value row is dequantized in-tile as
// bf16(float(x) * scale), the JAX package's _dequant_tile, before it
// enters the bf16 arithmetic below.
//
// Fused KV write (ragged only, k_new/v_new (T, K, hd) in the pool dtype):
// on the TPU the grid runs in order, so a program merges the chunk rows
// into a page, writes it back and then attends. Here the row tiles of one
// (sequence, kv head) run in parallel and in no order, so a tile that
// wrote a page would race the tiles that read it. Instead every tile
// reads the chunk's own positions [ctx - q_len, ctx) from k_new/v_new
// and only earlier positions from the pages, and each tile stores the
// chunk rows whose g = 0 query row it owns into the pages. The store is
// an exact copy and no tile reads what another writes, so the attention
// sees the same bits as after a separate scatter. The chunk's scale rows
// are scattered into the scale pools before the launch.
//
// What bounds it on this card: decode reads every live KV page once and
// does 4 flops per KV element and query head, so at glm4's G = 16 query
// heads per kv head it is bound by bytes (3.35 TB/s). A prefill chunk of
// a few hundred rows reuses each page for thousands of query rows and is
// bound by operations.
//
// What this design does about it (first, simple version):
//  * one thread block owns one (sequence, kv head, tile of up to ROWS of
//    the sequence's q_len*G query rows); it walks the block table in
//    order and skips dead pages with the TPU kernels' liveness tests (past
//    ctx; wholly before the earliest in-window key) plus a tile-level
//    causal cut (pages past the tile's last row position), which only
//    drops pages whose every score the row mask would zero;
//  * each live page is loaded into shared memory once, with 16-byte
//    loads, dequantized there to bf16 for a narrow pool, for all G query
//    heads of its kv head: the GQA reuse the TPU kernel gets from
//    computing a (G, hd) block per program. int8/fp8 pages move half the
//    bytes of bf16 ones;
//  * the next page's K and V (and scales) are loaded into registers while
//    the current page is computed, hiding the global-memory latency;
//  * scores, the online softmax (with the masked-row guard) and the
//    p @ v accumulation run in fp32 on the CUDA cores, each in a fixed
//    order per row and with explicitly rounded operations (no contraction
//    left to the compiler), so a row's result depends only on its own
//    query and its sequence's keys: not on C, B, S, the row tile or the
//    entry point.
// No split over the KV axis: it would change the reduction order. The
// tensor cores are not used. Both are for a later change.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 256;
constexpr int kMaxBs = 32;           // largest block_size the kernel takes
constexpr float kNegInf = -1.0e30f;

enum Mode : int { kChunk = 0, kRagged = 1, kRaggedWrite = 2 };

// Pool element codes shared with the Python wrappers.
enum PoolType : int { kPoolBf16 = 0, kPoolInt8 = 1, kPoolFp8 = 2 };

struct Args {
  const __nv_bfloat16* q;
  void* k_pages;                     // written only by kRaggedWrite
  void* v_pages;
  const float* k_scale;              // null for a bf16 pool
  const float* v_scale;
  const void* k_new;                 // kRaggedWrite only
  const void* v_new;
  const int* block_tables;
  const int* ctx_lens;
  const int* q_lens;                 // kChunk; null: decode (q_len 1)
  const int* starts;                 // kRagged*
  const int* ends;
  __nv_bfloat16* out;
  int C, H, K, bs, nb, n_tiles;
  float scale, cap;
  int window;
};

// A narrow pool element (the low byte of `b`) as float: exact.
template <typename T>
struct Narrow;

template <>
struct Narrow<int8_t> {
  __device__ __forceinline__ static float to_float(uint32_t b) {
    return static_cast<float>(static_cast<int8_t>(b & 0xffu));
  }
};

template <>
struct Narrow<__nv_fp8_e4m3> {
  __device__ __forceinline__ static float to_float(uint32_t b) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(b & 0xffu), __NV_E4M3);
    return __half2float(__half(h));
  }
};

// 16 narrow elements x scale -> 16 bf16 at dst (4-byte aligned): each
// bf16(float(x) * s), as the JAX package's _dequant_tile.
template <typename T>
__device__ __forceinline__ void dequant16(const uint4& v, float s,
                                          __nv_bfloat16* dst) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lo = __fmul_rn(Narrow<T>::to_float(w[i] >> (16 * h)), s);
      const float hi =
          __fmul_rn(Narrow<T>::to_float(w[i] >> (16 * h + 8)), s);
      __nv_bfloat162 pr =
          __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
      d[2 * i + h] = *reinterpret_cast<const uint32_t*>(&pr);
    }
  }
}

template <int HD, int ROWS, typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args a) {
  constexpr int QS = HD + 2;         // padded bf16 row: odd word stride
  constexpr int QVEC = HD / 8;       // 16-byte vectors per bf16 q row
  constexpr int EPV = 16 / sizeof(T);            // pool elements per vector
  constexpr int VEC = HD / EPV;      // 16-byte vectors per pool row
  constexpr int EPT = ROWS * HD / kThreads;      // acc elements per thread
  constexpr int NV = (kMaxBs * VEC + kThreads - 1) / kThreads;
  constexpr bool QUANT = sizeof(T) == 1;          // int8 / fp8 pool

  __shared__ __align__(16) __nv_bfloat16 q_s[ROWS][QS];
  __shared__ __align__(16) __nv_bfloat16 k_s[kMaxBs][QS];
  __shared__ __align__(16) __nv_bfloat16 v_s[kMaxBs][HD];
  __shared__ float p_s[ROWS][kMaxBs + 1];
  __shared__ unsigned char ok_s[ROWS][kMaxBs];
  __shared__ float m_s[ROWS], l_s[ROWS], corr_s[ROWS];

  const int tid = threadIdx.x;
  int bid = blockIdx.x;
  const int tile = bid % a.n_tiles;
  bid /= a.n_tiles;
  const int kh = bid % a.K;
  const int b = bid / a.K;           // the sequence
  const int H = a.H, K = a.K, bs = a.bs, nb = a.nb;
  const int G = H / K;
  const int r0 = tile * ROWS;

  const int ctx = a.ctx_lens[b];
  int qlen, row0, rows_total;        // row0: q/out row of chunk row 0
  if constexpr (MODE == kChunk) {
    qlen = a.q_lens ? a.q_lens[b] : 1;
    row0 = b * a.C;
    rows_total = a.C * G;            // padding rows come out as zeros
  } else {
    row0 = a.starts[b];
    qlen = max(a.ends[b] - row0, 0);
    rows_total = qlen * G;
    if (r0 >= rows_total) return;    // past this sequence's rows
  }
  const int qstart = ctx - qlen;     // absolute position of chunk row 0
  const T* k_pages = static_cast<const T*>(a.k_pages);
  const T* v_pages = static_cast<const T*>(a.v_pages);
  const T* k_new = static_cast<const T*>(a.k_new);
  const T* v_new = static_cast<const T*>(a.v_new);

  if constexpr (MODE == kRaggedWrite) {
    // store the chunk rows whose g = 0 query row is in this tile: each
    // chunk row is stored by exactly one tile; nothing reads it back
    const int c_first = (r0 + G - 1) / G;
    const int n_c = max(min(qlen, (r0 + ROWS + G - 1) / G) - c_first, 0);
    for (int i = tid; i < 2 * n_c * VEC; i += kThreads) {
      const int which = i / (n_c * VEC), rem = i % (n_c * VEC);
      const int c = c_first + rem / VEC, c8 = rem % VEC;
      const int pos = qstart + c;
      if (pos < 0) continue;
      const int page = a.block_tables[b * nb + min(pos / bs, nb - 1)];
      const size_t dst = ((size_t)(page * bs + pos % bs) * K + kh) * HD;
      const size_t src = ((size_t)(row0 + c) * K + kh) * HD;
      const T* from = which ? v_new : k_new;
      T* to = static_cast<T*>(which ? a.v_pages : a.k_pages);
      reinterpret_cast<uint4*>(to + dst)[c8] =
          reinterpret_cast<const uint4*>(from + src)[c8];
    }
  }

  // query tile -> shared memory (zeros past the last row)
  for (int i = tid; i < ROWS * QVEC; i += kThreads) {
    const int r = i / QVEC, c8 = i % QVEC, rr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rr < rows_total) {
      const int c = rr / G, g = rr % G;
      val = reinterpret_cast<const uint4*>(
          a.q + ((size_t)(row0 + c) * H + g * K + kh) * HD)[c8];
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
  if (a.window > 0) {
    while (jlo < jhi && jlo * bs + bs - 1 <= qstart - a.window) ++jlo;
  }

  float acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = 0.f;

  uint4 kreg[NV], vreg[NV];
  float kscl[NV], vscl[NV];
  auto load_page = [&](int j) {
    const int page = a.block_tables[b * nb + j];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < bs * VEC) {
        const int t = idx / VEC, c8 = idx % VEC;
        const size_t prow = (size_t)(page * bs + t) * K + kh;
        const T* ksrc = k_pages + prow * HD;
        const T* vsrc = v_pages + prow * HD;
        if constexpr (MODE == kRaggedWrite) {
          const int p = j * bs + t;   // the chunk's own keys: from k_new
          if (p >= qstart && p < ctx) {
            const size_t nrow = (size_t)(row0 + p - qstart) * K + kh;
            ksrc = k_new + nrow * HD;
            vsrc = v_new + nrow * HD;
          }
        }
        kreg[i] = reinterpret_cast<const uint4*>(ksrc)[c8];
        vreg[i] = reinterpret_cast<const uint4*>(vsrc)[c8];
        if constexpr (QUANT) {
          kscl[i] = a.k_scale[prow];
          vscl[i] = a.v_scale[prow];
        }
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
        if constexpr (QUANT) {
          dequant16<T>(kreg[i], kscl[i], &k_s[t][c8 * EPV]);
          dequant16<T>(vreg[i], vscl[i], &v_s[t][c8 * EPV]);
        } else {
          uint32_t* kd = reinterpret_cast<uint32_t*>(&k_s[t][c8 * 8]);
          kd[0] = kreg[i].x; kd[1] = kreg[i].y;
          kd[2] = kreg[i].z; kd[3] = kreg[i].w;
          reinterpret_cast<uint4*>(&v_s[t][0])[c8] = vreg[i];
        }
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
      if (a.window > 0) ok = ok && kpos > qpos - a.window;
      float s = 0.f;
      const __nv_bfloat162* qv =
          reinterpret_cast<const __nv_bfloat162*>(&q_s[r][0]);
      const __nv_bfloat162* kv =
          reinterpret_cast<const __nv_bfloat162*>(&k_s[t][0]);
#pragma unroll 8
      for (int d = 0; d < HD / 2; ++d) {
        const float2 x = __bfloat1622float2(qv[d]);
        const float2 y = __bfloat1622float2(kv[d]);
        s = fmaf(x.x, y.x, s);
        s = fmaf(x.y, y.y, s);
      }
      s = __fmul_rn(s, a.scale);
      if (a.cap > 0.f) s = __fmul_rn(a.cap, tanhf(__fdiv_rn(s, a.cap)));
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
        const float p =
            ok_s[r][t] ? expf(__fsub_rn(p_s[r][t], m_new)) : 0.f;
        p_s[r][t] = p;
        lsum = __fadd_rn(lsum, p);
      }
      const float corr = expf(__fsub_rn(m_prev, m_new));
      l_s[r] = fmaf(l_s[r], corr, lsum);
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
      acc[i] = fmaf(acc[i], corr_s[r], t_sum);
    }
  }
  __syncthreads();

  // finalize: acc / max(l, 1e-37) -> bf16, back to the q row layout
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / HD, d = e % HD, rr = r0 + r;
    if (rr < rows_total) {
      const int c = rr / G, g = rr % G;
      const float l = fmaxf(l_s[r], 1e-37f);
      a.out[((size_t)(row0 + c) * H + g * K + kh) * HD + d] =
          __float2bfloat16_rn(__fdiv_rn(acc[i], l));
    }
  }
}

// `rows` is the row count one sequence can hold (C*G, or T*G when packed):
// it picks the row tile, which only sets how many rows share a page load;
// no row's arithmetic depends on it.
template <typename T, int MODE, int HD>
cudaError_t launch_hd(Args a, int n_seqs, int rows, cudaStream_t stream) {
  if (rows <= 16) {
    a.n_tiles = (rows + 15) / 16;
    paged_attention_kernel<HD, 16, T, MODE>
        <<<(unsigned)(n_seqs * a.K * a.n_tiles), kThreads, 0, stream>>>(a);
  } else {
    a.n_tiles = (rows + 63) / 64;
    paged_attention_kernel<HD, 64, T, MODE>
        <<<(unsigned)(n_seqs * a.K * a.n_tiles), kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_type(const Args& a, int n_seqs, int rows, int hd,
                        cudaStream_t stream) {
  switch (hd) {     // glm4_9b: 128; zamba2_2p7b: 80; smoke sizes: 16
    case 16:
      return launch_hd<T, MODE, 16>(a, n_seqs, rows, stream);
    case 80:
      return launch_hd<T, MODE, 80>(a, n_seqs, rows, stream);
    case 128:
      return launch_hd<T, MODE, 128>(a, n_seqs, rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Launch on `stream`; returns cudaGetLastError() after the launch.
template <int MODE>
int launch(const Args& a, int n_seqs, int rows, int hd, int pool_type,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_seqs == 0 || rows == 0) return static_cast<int>(cudaGetLastError());
  const bool has_scales = a.k_scale != nullptr && a.v_scale != nullptr;
  if ((pool_type != kPoolBf16) != has_scales)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (pool_type) {
    case kPoolBf16:
      e = launch_type<__nv_bfloat16, MODE>(a, n_seqs, rows, hd, s);
      break;
    case kPoolInt8:
      e = launch_type<int8_t, MODE>(a, n_seqs, rows, hd, s);
      break;
    case kPoolFp8:
      e = launch_type<__nv_fp8_e4m3, MODE>(a, n_seqs, rows, hd, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // namespace paged
