// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_fwd_kernel, driven by _flash_fwd): dense GQA attention that returns the
// output and the fp32 log-sum-exp of every query row, which the backward
// (a plain PyTorch function, as in the JAX package) reads.
//
// Semantics (same as the TPU kernel): q (B, Sq, H, hd), k/v (B, Skv, K, hd)
// bf16, g-major GQA (q head h reads kv head h % K). Logits are
// (q . k) * scale in fp32, then softcapped (cap * tanh(s / cap)) when
// cap > 0, then masked to -1e30: keys at or past Skv always; with causal,
// keys after the row's absolute position q_offset + i, and with a window
// (> 0) keys at or before position - window. An fp32 online softmax
// (m, l, acc) runs over the key tiles; o = acc / max(l, 1e-37) in bf16 and
// lse = m + log(max(l, 1e-37)) in fp32. Key tiles wholly above the causal
// diagonal or wholly before the window are skipped, as pl.when(live) skips
// them on the TPU.
//
// What bounds it on this card: at training shapes (S = 2048, hd = 128) each
// key is reused by thousands of query rows, so it is bound by operations:
// 4 * hd flops per causal (row, key) pair at the bf16 tensor-core rate.
//
// What this design does about it (first, simple version):
//  * one thread block of 4 warps owns a (batch, q head, tile of 64 query
//    rows); each warp owns 16 rows and keeps their q fragments, scores,
//    softmax state and output accumulator in registers. The TPU grid's
//    sequential kv axis becomes a loop inside the block;
//  * each 64-key tile of K and V is copied into shared memory with 16-byte
//    loads (rows padded by 8 values, so fragment reads hit 32 banks);
//  * q k^T and p v run on the tensor cores as mma.sync m16n8k16 bf16
//    products with fp32 accumulation. The scores stay in fp32 (bf16
//    products are exact in fp32, as on the TPU's fp32 dot); the
//    probabilities enter p v rounded to bf16, while l sums them in fp32;
//  * query tiles are launched from the last (longest causal row) first.
// Every sum has one fixed order (no atomics, no split over keys), so two
// launches on the same inputs give the same bits: remat's recompute of the
// forward reproduces it exactly. Not yet used: wgmma, TMA, a pipelined
// ring of tiles, a split over keys. Those are for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block, 16 per warp
constexpr int BKV = 64;         // keys per tile
constexpr int THREADS = 128;
constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_halves(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a (16x16, row major) * b (16x8, column major); bf16 in, fp32 sum.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of m16n8k16 (lane = 4 * g + t): an A register holds row
// g or g + 8 at columns 2t, 2t + 1 (+ 8); a B register holds rows (k) 2t,
// 2t + 1 (+ 8) of column g; the accumulator holds rows g and g + 8 at
// columns 2t, 2t + 1.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int H, int K, float scale, float cap,
                 int causal, int window, int q_offset) {
  constexpr int STRIDE = HD + 8;       // padded shared-memory row, values
  constexpr int KSTEPS = HD / 16;      // k-steps of q k^T
  constexpr int NT_O = HD / 8;         // 8-column tiles of the output
  constexpr int VECS = HD / 8;         // 16-byte vectors per row
  __shared__ __align__(16) __nv_bfloat16 ks[BKV * STRIDE];
  __shared__ __align__(16) __nv_bfloat16 vs[BKV * STRIDE];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h % K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * BQ;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < Sq;
    const __nv_bfloat16* qr = q + ((size_t)(b * Sq + rows[r]) * H + h) * HD;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      qf[s][r] = ok ? ld32(qr + s * 16 + 2 * t) : 0u;
      qf[s][r + 2] = ok ? ld32(qr + s * 16 + 8 + 2 * t) : 0u;
    }
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // live key range of this tile of rows (the TPU kernel's pl.when test)
  const int first_q = q_offset + q0, last_q = first_q + BQ - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) {
    kv_hi = min(Skv, last_q + 1);
    if (window > 0) kv_lo = max(0, first_q - window + 1);
  }
  const int tile_lo = kv_lo / BKV, tile_hi = (kv_hi + BKV - 1) / BKV;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int kv0 = tile * BKV;
    __syncthreads();
    for (int i = threadIdx.x; i < BKV * VECS; i += THREADS) {
      const int r = i / VECS, c = i % VECS, s = kv0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (s < Skv) {
        const size_t off = ((size_t)(b * Skv + s) * K + kh) * HD + c * 8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + r * STRIDE + c * 8) = kv;
      *reinterpret_cast<uint4*>(vs + r * STRIDE + c * 8) = vv;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * STRIDE + 2 * t;
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st)
        mma_bf16(s[n], qf[st], ld32(kr + st * 16), ld32(kr + st * 16 + 8));
    }

    // scale, softcap, mask; the new row maxima
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = kv0 + n * 8 + 2 * t + (e & 1);
        float z = s[n][e] * scale;
        if (cap > 0.f) z = cap * tanhf(z / cap);
        bool ok = kpos < Skv;
        if (causal) {
          const int dd = q_offset + rows[r] - kpos;
          ok = ok && dd >= 0 && (window <= 0 || dd < window);
        }
        z = ok ? z : NEG_INF;
        s[n][e] = z;
        mx[r] = fmaxf(mx[r], z);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }

    // acc += p v: the scores' accumulator layout is the A layout of p
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                        pack_bf16(s[2 * j][2], s[2 * j][3]),
                        pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                        pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* v0 = vs + (16 * j + 2 * t) * STRIDE + g;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat16* vc = v0 + n * 8;
        mma_bf16(acc[n], pa, pack_halves(vc[0], vc[STRIDE]),
                 pack_halves(vc[8 * STRIDE], vc[9 * STRIDE]));
      }
    }
  }

  // each thread summed its own columns: combine the quad in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    const float ll = fmaxf(l[r], 1e-37f);
    const size_t row = (size_t)(b * Sq + rows[r]) * H + h;
    __nv_bfloat16* orow = o + row * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * r] / ll, acc[n][2 * r + 1] / ll);
    if (t == 0) lse[row] = m[r] + logf(ll);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Skv, int H, int K, float scale, float cap,
           int causal, int window, int q_offset, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Skv, H, K, scale, cap, causal, window,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k/v (B, Skv, K, hd) bf16 contiguous -> o (B, Sq, H, hd)
// bf16, lse (B, Sq, H) fp32. hd is 16 or 128; cap <= 0 means no softcap,
// window <= 0 no window. Returns cudaGetLastError() after the launch (-1
// for a head dim it was not built for).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int Sq, int Skv, int H, int K,
                        int hd, float scale, float cap, int causal,
                        int window, int q_offset, void* stream) {
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, Sq, Skv, H, K, scale, cap, causal,
                        window, q_offset, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Sq, Skv, H, K, scale, cap,
                         causal, window, q_offset, st);
    default:
      return -1;
  }
}

}  // extern "C"
