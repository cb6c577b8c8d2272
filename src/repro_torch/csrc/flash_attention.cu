// Flash attention forward for Hopper (sm_90a), in two designs chosen by
// head dim.
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
// 4 * hd flops per causal (row, key) pair at the bf16 tensor-core rate
// (68.7 GFLOP at B=2, S=2048, H=32: 0.0695 ms at 989 TFLOP/s). So are
// whisper's encoder (hd 64, non-causal 1500 x 1500) and zamba2's shared
// block (hd 80, causal S 2048).
//
// Routes "wgmma" (hd 128, the training path), "wgmma80" (hd 80, zamba2's
// shared attention block) and "wgmma64" (hd 64, whisper's encoder, cross
// and static prefill attention): one template on the head dim, designed
// for Hopper:
//  * a block owns 128 query rows of one (batch, q head): two warpgroups of
//    64 rows (or, at hd 64 where 128-row blocks would not give every SM
//    two, 64 rows and one warpgroup: pick_rows). Query tiles are on the
//    grid's slow axis, the last (longest causal) tile first. There is no
//    producer warp: a 288- or 384-thread block is held to 168 registers a
//    thread (the compiler does not give the consumers setmaxnreg's 240
//    here), and the hd-128 loop needs 254;
//  * one thread loads Q once and each 128-key tile of K and V with TMA
//    (cp.async.bulk.tensor over the (hd, heads, S, B) view of the (B, S,
//    heads, hd) tensors) into a 3-stage ring, two tiles ahead of their
//    use, with mbarrier completion and release. A row is cut into
//    128B-swizzled boxes of 64 values (one at hd 64, two at hd 128) and,
//    at hd 80, a 32B-swizzled box of the last 16 values (a 128B swizzle
//    holds at most 64 bf16 a row; each box gets wgmma descriptors of its
//    own swizzle). TMA fills rows past Sq and Skv with zeros; keys past
//    Skv are masked all the same, since a zero score is not -1e30;
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major, hd / 16 k-steps: 8, 5 or 4); O += P V is wgmma m64n{hd}k16
//    over the 64-value boxes (n128 spans both at hd 128) and m64n16k16
//    over the 16-value box, with P from registers (the scores'
//    accumulator layout is the A-fragment layout once P is rounded to
//    bf16) and V read through the transpose bit. Per tile a warpgroup
//    issues S(j) and P(j-1) V(j-1) together and runs the softmax of S(j)
//    while P V runs;
//  * the softmax runs in base 2 (scale and log2 e in one multiply, ex2 on
//    the special-function unit); only tiles on the diagonal, the window's
//    edge or the Skv edge are masked, branch-free, against per-row key
//    bounds. The scores stay fp32 (bf16 products are exact in fp32); P
//    enters P V rounded to bf16, while l sums fp32;
//  * the output is scaled by 1 / l, staged in the warpgroup's own rows of
//    the Q tile (swizzled as the boxes are) and written by TMA, which
//    leaves out rows past Sq.
// Route "mma" (hd 8, 12 and 16, the smoke configs): 4 warps own 64 rows,
// each 64-key tile is copied to shared memory with plain loads into
// 16-value rows (columns past hd zeroed, which changes no q . k and no
// output column that is kept), and both products are mma.sync m16n8k16
// with fp32 accumulation; P enters P V as a bf16 high part and a bf16
// remainder, two products into one accumulator (short rows of 8 or 12
// values are not held within 1e-2 of the fp32 P V with one rounding).
// In every route, every sum has one fixed order (no atomics, no split over keys),
// so two launches on the same inputs give the same bits: remat's
// recompute of the forward reproduces it exactly.

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"  // mbarriers, wgmma descriptors and fences, ex2
#include "mma.cuh"     // mma_bf16, pack_bf16

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// route "mma": hd 8, 12 and 16
// ---------------------------------------------------------------------------

constexpr int BQ = 64;          // query rows per block, 16 per warp
constexpr int BKV = 64;         // keys per tile
constexpr int THREADS = 128;
constexpr int HDP = 16;         // the shared rows' width: one k-step

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_halves(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// m16n8k16 fragments as mma.cuh lays them out. A row holds HD real values
// (global stride HD) in a shared row of HDP, the rest zero.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int H, int K, float scale, float cap,
                 int causal, int window, int q_offset) {
  static_assert(HD % 4 == 0 && HD <= HDP, "hd 4k up to 16");
  constexpr int STRIDE = HDP + 8;      // padded shared-memory row, values
  constexpr int NT_O = (HD + 7) / 8;   // 8-column tiles of the output
  // vectors per shared row: 16 bytes when a row is a multiple of 8
  // values, else 8 (hd 12: 24-byte rows)
  using Vec = typename std::conditional<HD % 8 == 0, uint4, uint2>::type;
  constexpr int VW = sizeof(Vec) / 2;  // values per vector
  constexpr int VECS = HDP / VW;
  __shared__ __align__(16) __nv_bfloat16 ks[BKV * STRIDE];
  __shared__ __align__(16) __nv_bfloat16 vs[BKV * STRIDE];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h % K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * BQ;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  uint32_t qf[4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < Sq;
    const __nv_bfloat16* qr = q + ((size_t)(b * Sq + rows[r]) * H + h) * HD;
    qf[r] = ok ? ld32(qr + 2 * t) : 0u;
    qf[r + 2] = ok && 8 + 2 * t < HD ? ld32(qr + 8 + 2 * t) : 0u;
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
      Vec kv{}, vv{};
      if (s < Skv && c * VW < HD) {
        const size_t off = ((size_t)(b * Skv + s) * K + kh) * HD + c * VW;
        kv = *reinterpret_cast<const Vec*>(k + off);
        vv = *reinterpret_cast<const Vec*>(v + off);
      }
      *reinterpret_cast<Vec*>(ks + r * STRIDE + c * VW) = kv;
      *reinterpret_cast<Vec*>(vs + r * STRIDE + c * VW) = vv;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * STRIDE + 2 * t;
      mma_bf16(s[n], qf, ld32(kr), ld32(kr + 8));
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

    // acc += p v: the scores' accumulator layout is the A layout of p.
    // p enters as two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), both
    // products summed in fp32: p to about 16 bits, as near the TPU
    // kernel's fp32 p . v as these rows need (one bf16 rounding of p put
    // an 8-value row 1e-2 of its norm from the fp32 product)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* sv = s[2 * j + (r >> 1)] + 2 * (r & 1);
        ph[r] = pack_bf16(sv[0], sv[1]);
        const float2 hf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ph[r]));
        pl[r] = pack_bf16(sv[0] - hf.x, sv[1] - hf.y);
      }
      const __nv_bfloat16* v0 = vs + (16 * j + 2 * t) * STRIDE + g;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat16* vc = v0 + n * 8;
        const uint32_t b0 = pack_halves(vc[0], vc[STRIDE]);
        const uint32_t b1 = pack_halves(vc[8 * STRIDE], vc[9 * STRIDE]);
        mma_bf16(acc[n], ph, b0, b1);
        mma_bf16(acc[n], pl, b0, b1);
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
      if (n * 8 + 2 * t < HD)       // only the real columns
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * r] / ll, acc[n][2 * r + 1] / ll);
    if (t == 0) lse[row] = m[r] + logf(ll);
  }
}

// ---------------------------------------------------------------------------
// routes "wgmma" (hd 128), "wgmma80" (hd 80) and "wgmma64" (hd 64)
// ---------------------------------------------------------------------------

namespace hop {

constexpr int BKV = 128;                   // keys per tile
constexpr int STAGES = 3;                  // K/V ring depth

// A tile of R rows of HD values: C0 = 64 or 128 values a row in
// 128B-swizzled boxes of 64 (R x 128 bytes each), then C1 = 0 or 16 in
// one 32B-swizzled box (R x 32 bytes).
template <int HD>
struct Layout {
  static constexpr int C0 = HD >= 128 ? 128 : 64;
  static constexpr int C1 = HD - C0;
  static_assert(HD == 64 || HD == 80 || HD == 128, "hd 64, 80 or 128");
  __host__ __device__ static constexpr int box_bytes(int rows) {
    return rows * 128;
  }
  __host__ __device__ static constexpr int part1(int rows) {
    return rows * C0 * 2;
  }
  __host__ __device__ static constexpr int tile_bytes(int rows) {
    return rows * HD * 2;
  }
};

// Shared memory of a block of WGS warpgroups, from a 1024-byte aligned base
// (the 128B swizzle repeats every 8 rows of 128 bytes): Q, K[STAGES],
// V[STAGES], then the barriers.
template <int HD, int WGS>
struct Smem {
  static constexpr int BQ = 64 * WGS;
  static constexpr int Q = 0;
  static constexpr int K = Q + Layout<HD>::tile_bytes(BQ);
  static constexpr int V = K + STAGES * Layout<HD>::tile_bytes(BKV);
  static constexpr int BAR = V + STAGES * Layout<HD>::tile_bytes(BKV);
  static constexpr int BYTES = BAR + 8 * (1 + 4 * STAGES) + 1024;
};

// wgmma shared-memory descriptor, 32B swizzle; lbo and sbo in bytes.
__device__ __forceinline__ uint64_t sdesc32(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (3ull << 62);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// One box of shared memory into a 4-D tensor map (rows past the tensor's
// end are not written), in this thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// Keeps the compiler from moving reads of an accumulator (or P's
// registers) across a wait, or reusing them while a wgmma reads them.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACC8(d, o)                                                           \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),            \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define ACC32(d, o) \
  ACC8(d, o), ACC8(d, o + 8), ACC8(d, o + 16), ACC8(d, o + 24)
#define ACC64(d) ACC32(d, 0), ACC32(d, 32)

#define STR8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define STR32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define STR64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, fp32) = or += a (64 x 16) * b (16 x 128), both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " STR64
      ", %64, %65, p, 1, 1, 0, 0;\n\t}"
      : ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, fp32) += a (64 x 16, bf16 fragments in registers) * b
// (16 x N), b MN-major in shared memory (the transpose bit); N = 128, 64
// or 16.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " STR64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " STR32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %13, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " STR8
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n\t}"
      : ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The online softmax of one tile of scores, in place: sc becomes the
// probabilities (fp32), l gains their sum, m the new row maxima, and corr
// is what the earlier tiles' output must be multiplied by. Base 2: z =
// s * scale * log2 e, or cap * log2 e * tanh(s * scale / cap); then the
// mask, where the tile needs one, to -1e30 * log2 e.
struct Softmax {
  float scale2, cap2, inv_cap, neg2;
  int t;
  // the live keys of the thread's two rows: positions lo[r] <= kpos <
  // hi[r] (kpos < Skv; with causal kpos <= the row's position; with a
  // window, kpos > the row's position - window)
  int lo[2], hi[2];

  __device__ __forceinline__ void operator()(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int kv0, bool need_mask) const {
    if (cap2 > 0.f) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = cap2 * tanhf(sc[i] * inv_cap);
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= scale2;
    }
    if (need_mask) {
      // element i is key kv0 + 2 t + c(i): compare the constant c(i) with
      // the bounds moved by kv0 + 2 t, without branches
      const int base = kv0 + 2 * t;
      const int lo_c[2] = {lo[0] - base, lo[1] - base};
      const int hi_c[2] = {hi[0] - base, hi[1] - base};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int c = 8 * (i >> 2) + (i & 1), r = (i >> 1) & 1;
        sc[i] = (c >= lo_c[r]) & (c < hi_c[r]) ? sc[i] : neg2;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }
  }
};

// Accumulator layout of m64nNk16 (thread = 128-thread warpgroup index,
// w = thread / 32, lane = 4 g + t): element i sits at row 16 w + g
// (+ 8 when bit 1 of i is set) and column 8 (i / 4) + 2 t + (i & 1).
// The A fragment of one k16 step holds the same (row, column) pairs, so
// columns 16 kk .. 16 kk + 15 of the probabilities, elements 8 kk .. 8 kk
// + 7, pack pairwise into the four A registers of k-step kk.
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[32]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) pa[i >> 1] = pack_bf16(sc[i], sc[i + 1]);
}

// The tensor maps of one operand: the 128B-swizzled boxes of its first C0
// values and the 32B-swizzled box of the last C1 (unused when C1 = 0).
struct Maps {
  CUtensorMap sw128, sw32;
};

// Per tile j each warpgroup issues S(j) = Q K(j)^T, rescales O (the
// CUDA cores, while S(j) runs), issues O += P(j-1) V(j-1), waits for S(j)
// alone and runs its softmax while the tensor cores finish P V. One thread of
// warpgroup 0 also issues the TMA loads, two tiles ahead: K(j + 2) and
// V(j + 1) in tile j, each into the stage its predecessor three tiles back
// has left (every warpgroup released it a tile ago, so the wait is
// normally over). All threads compute: no producer warps, so each thread
// may hold 255 registers.
template <int HD, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1)
flash_fwd_wgmma(__grid_constant__ const Maps qmap,
                __grid_constant__ const Maps kmap,
                __grid_constant__ const Maps vmap,
                __grid_constant__ const Maps omap,
                float* __restrict__ lse,
                int Sq, int Skv, int H, int K, float scale, float cap,
                int causal, int window, int q_offset) {
  using L = Layout<HD>;
  using SM = Smem<HD, WGS>;
  constexpr int THREADS = 128 * WGS, BQ = SM::BQ;
  constexpr int C0 = L::C0, C1 = L::C1, N0 = C0 / 64;
  constexpr int KV_TILE = L::tile_bytes(BKV), Q_TILE = L::tile_bytes(BQ);
  constexpr int KV_BOX = L::box_bytes(BKV), Q_BOX = L::box_bytes(BQ);
  constexpr int KV_P1 = L::part1(BKV), Q_P1 = L::part1(BQ);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base + SM::Q, k_s = base + SM::K, v_s = base + SM::V;
  // barriers: q_full, then per stage k_full, v_full, k_empty, v_empty
  const uint32_t q_full = base + SM::BAR;
  auto k_full = [&](int s) { return q_full + 8 * (1 + 4 * s); };
  auto v_full = [&](int s) { return q_full + 8 * (2 + 4 * s); };
  auto k_empty = [&](int s) { return q_full + 8 * (3 + 4 * s); };
  auto v_empty = [&](int s) { return q_full + 8 * (4 + 4 * s); };

  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h % K;
  const int q0 = qt * BQ;

  // live key range of this tile of rows (the TPU kernel's pl.when test)
  const int first_q = q_offset + q0, last_q = first_q + BQ - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) {
    kv_hi = min(Skv, last_q + 1);
    if (window > 0) kv_lo = max(0, first_q - window + 1);
  }
  const int tile_lo = kv_lo / BKV;
  const int n_tiles = max(0, (kv_hi + BKV - 1) / BKV - tile_lo);

  // rows r0 .. r0 + rows - 1 of head `hh` of one operand into dst
  auto load_tile = [&](uint32_t dst, const Maps& map, uint32_t bar,
                       int box_bytes, int p1, int hh, int r0) {
#pragma unroll
    for (int i = 0; i < N0; ++i)
      tma_load(dst + i * box_bytes, &map.sw128, bar, 64 * i, hh, r0, b);
    if constexpr (C1 > 0) tma_load(dst + p1, &map.sw32, bar, C0, hh, r0, b);
  };
  const bool loader = threadIdx.x == 0;
  // tile j of K (or V) into stage j % STAGES, once tile j - STAGES has left
  auto load_kv = [&](int j, uint32_t ring, const Maps& map, uint32_t full,
                     uint32_t empty) {
    if (j >= STAGES) mbar_wait(empty, ((j / STAGES) - 1) & 1);
    mbar_expect_tx(full, KV_TILE);
    load_tile(ring + (j % STAGES) * KV_TILE, map, full, KV_BOX, KV_P1, kh,
              (tile_lo + j) * BKV);
  };
  auto load_k = [&](int j) {
    load_kv(j, k_s, kmap, k_full(j % STAGES), k_empty(j % STAGES));
  };
  auto load_v = [&](int j) {
    load_kv(j, v_s, vmap, v_full(j % STAGES), v_empty(j % STAGES));
  };

  if (loader) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), THREADS);
      mbar_init(v_empty(s), THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(q_full, Q_TILE);
    load_tile(q_s, qmap, q_full, Q_BOX, Q_P1, h, q0);
    for (int j = 0; j < min(n_tiles, 2); ++j) load_k(j);
    if (n_tiles > 0) load_v(0);
  }
  __syncthreads();

  // warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63 (broadcast from
  // lane 0, so the compiler knows it is the same across the warp)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row = q0 + 64 * wg + 16 * (tid >> 5) + g;  // and row + 8
  const float neg2 = NEG_INF * LOG2E;                  // -1e30, base 2
  Softmax softmax{scale * LOG2E, cap > 0.f ? cap * LOG2E : 0.f,
                  cap > 0.f ? scale / cap : 0.f, neg2, t};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q_offset + row + 8 * r;
    softmax.hi[r] = causal ? min(Skv, pos + 1) : Skv;
    softmax.lo[r] = causal && window > 0 ? pos - window + 1 : 0;
  }
  // whether a tile needs a mask: the Skv edge, the causal diagonal, the
  // window's edge
  auto need_mask = [&](int kv0) {
    return kv0 + BKV > Skv ||
           (causal && (kv0 + BKV - 1 > first_q ||
                       (window > 0 && kv0 <= last_q - window)));
  };
  // this warpgroup's 64 rows of Q: the 128B boxes, then the 32B box
  const uint32_t q_wg = q_s + wg * 64 * 128, q_wg1 = q_s + Q_P1 + wg * 64 * 32;
  auto issue_s = [&](float (&sc)[64], uint32_t kt) {
#pragma unroll
    for (int kk = 0; kk < C0 / 16; ++kk) {
      const int col = (kk & 3) * 32;
      wgmma_ss(sc, sdesc(q_wg + (kk >> 2) * Q_BOX + col, 16, 1024),
               sdesc(kt + (kk >> 2) * KV_BOX + col, 16, 1024), kk > 0);
    }
    if constexpr (C1 > 0)
      wgmma_ss(sc, sdesc32(q_wg1, 16, 256), sdesc32(kt + KV_P1, 16, 256), 1);
    wg_commit();
  };
  // O += P V over 16 keys a k-step: n = C0 over the 128B boxes (their
  // stride is the descriptor's leading offset), n16 over the 32B box
  auto issue_pv = [&](float (&acc)[C0 / 2], float (&acc1)[8],
                      const uint32_t (&pa)[32], uint32_t vt) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_rs(acc, pa + 4 * kk, sdesc(vt + kk * 2048, KV_BOX, 1024));
      if constexpr (C1 > 0)
        wgmma_rs(acc1, pa + 4 * kk,
                 sdesc32(vt + KV_P1 + kk * 512, KV_P1, 256));
    }
    wg_commit();
  };
  // the loads tile j issues: K(j + 2) and V(j + 1)
  auto prefetch = [&](int j) {
    if (!loader) return;
    if (j + 2 < n_tiles) load_k(j + 2);
    if (j + 1 < n_tiles) load_v(j + 1);
  };

  float acc[C0 / 2], acc1[8], sc[64], corr[2];
  uint32_t pa[32];
  auto pin_acc = [&]() {
    pin(acc);
    if constexpr (C1 > 0) pin(acc1);
  };
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < C0 / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    if constexpr (C1 > 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc1[i] *= corr[(i >> 1) & 1];
    }
    pin_acc();
  };
#pragma unroll
  for (int i = 0; i < C0 / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc1[i] = 0.f;
  float m[2] = {neg2, neg2}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    const int kv0 = tile_lo * BKV;
    mbar_wait(k_full(0), 0);
    wg_fence();
    issue_s(sc, k_s);
    prefetch(0);
    wg_wait<0>();
    pin(sc);
    mbar_arrive(k_empty(0));
    softmax(sc, m, l, corr, kv0, need_mask(kv0));
    pack_p(sc, pa);
    pin(pa);
  }
  for (int it = 1; it < n_tiles; ++it) {
    const int s = it % STAGES, ps = (it - 1) % STAGES;
    const int kv0 = (tile_lo + it) * BKV;
    mbar_wait(k_full(s), (it / STAGES) & 1);
    mbar_wait(v_full(ps), ((it - 1) / STAGES) & 1);
    wg_fence();
    issue_s(sc, k_s + s * KV_TILE);
    rescale();
    wg_fence();
    issue_pv(acc, acc1, pa, v_s + ps * KV_TILE);
    prefetch(it);
    wg_wait<1>();
    pin(sc);
    mbar_arrive(k_empty(s));
    softmax(sc, m, l, corr, kv0, need_mask(kv0));
    wg_wait<0>();
    pin_acc();
    pin(pa);
    mbar_arrive(v_empty(ps));
    pack_p(sc, pa);
    pin(pa);
  }
  if (n_tiles > 0) {
    const int ps = (n_tiles - 1) % STAGES;
    mbar_wait(v_full(ps), ((n_tiles - 1) / STAGES) & 1);
    rescale();
    wg_fence();
    issue_pv(acc, acc1, pa, v_s + ps * KV_TILE);
    wg_wait<0>();
    pin_acc();
  }

  // each thread summed its own columns: combine the quad in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // o = acc / l in bf16, written into this warpgroup's 64 rows of the Q
  // tile (free once its last S product is done), swizzled as the boxes
  // are (the 128B swizzle moves 16-byte chunk c of row rr to c ^ (rr & 7),
  // the 32B one to c ^ ((rr >> 2) & 1)), then stored by TMA, which leaves
  // out rows past Sq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ll = fmaxf(l[r], 1e-37f), inv = 1.f / ll;
    const int rr = 16 * (tid >> 5) + g + 8 * r;  // row within the 64
#pragma unroll
    for (int j = 0; j < C0 / 8; ++j)
      st_shared(q_wg + (j >> 3) * Q_BOX + rr * 128 +
                    (((j & 7) ^ (rr & 7)) << 4) + 4 * t,
                pack_bf16(acc[4 * j + 2 * r] * inv,
                          acc[4 * j + 2 * r + 1] * inv));
    if constexpr (C1 > 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        st_shared(q_wg1 + rr * 32 + ((j ^ ((rr >> 2) & 1)) << 4) + 4 * t,
                  pack_bf16(acc1[4 * j + 2 * r] * inv,
                            acc1[4 * j + 2 * r + 1] * inv));
    }
    if (t == 0 && row + 8 * r < Sq)
      lse[(size_t)(b * Sq + row + 8 * r) * H + h] = m[r] * LN2 + logf(ll);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  wg_bar_sync(1 + wg);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < N0; ++i)
      tma_store(&omap.sw128, q_wg + i * Q_BOX, 64 * i, h, q0 + 64 * wg, b);
    if constexpr (C1 > 0) tma_store(&omap.sw32, q_wg1, C0, h, q0 + 64 * wg, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

#undef ACC8
#undef ACC32
#undef ACC64
#undef STR8
#undef STR32
#undef STR64

// A (B, S, N, hd) bf16 tensor seen as (hd, N, S, B), boxes of `cols`
// values x 1 head x `rows` rows, 128B-swizzled (64 values) or 32B-swizzled
// (16); rows past S read as zeros and are not written.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hd,
            int B, int S, int N, int cols, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)N, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {hd * 2ull, (cuuint64_t)N * hd * 2,
                                 (cuuint64_t)S * N * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Both maps of one operand (the 32B one only where the head dim has a
// 16-value tail).
template <int HD>
bool encode_maps(EncodeTiled fn, Maps* maps, const void* ptr, int B, int S,
                 int N, int rows) {
  maps->sw32 = {};
  return encode(fn, &maps->sw128, ptr, HD, B, S, N, 64, rows) &&
         (Layout<HD>::C1 == 0 ||
          encode(fn, &maps->sw32, ptr, HD, B, S, N, 16, rows));
}

template <int HD, int WGS>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Skv, int H, int K, float scale, float cap,
           int causal, int window, int q_offset, cudaStream_t stream) {
  constexpr int BQ = Smem<HD, WGS>::BQ, BYTES = Smem<HD, WGS>::BYTES;
  EncodeTiled fn = encode_tiled();
  Maps qm, km, vm, om;
  if (fn == nullptr || !encode_maps<HD>(fn, &qm, q, B, Sq, H, BQ) ||
      !encode_maps<HD>(fn, &km, k, B, Skv, K, BKV) ||
      !encode_maps<HD>(fn, &vm, v, B, Skv, K, BKV) ||
      !encode_maps<HD>(fn, &om, o, B, Sq, H, 64))
    return -1;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD, WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_wgmma<HD, WGS><<<grid, 128 * WGS, BYTES, stream>>>(
      qm, km, vm, om, static_cast<float*>(lse), Sq, Skv, H, K, scale, cap,
      causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// hd 64's block height: 64 rows (one warpgroup, two blocks an SM) where
// 128-row blocks would not give every SM of the current card two, else
// 128. hd 80 and 128 always take 128: their ring leaves room for one
// block an SM at either height.
int pick_rows(int B, int Sq, int H) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 128;
  return (long)B * H * ((Sq + 127) / 128) < 2L * sms ? 64 : 128;
}

}  // namespace hop

// The mma.sync route on `stream`.
template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Sq, int Skv, int H, int K, float scale,
               float cap, int causal, int window, int q_offset,
               cudaStream_t stream) {
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

// The entry point: q (B, Sq, H, hd), k/v (B, Skv, K, hd) bf16 contiguous
// -> o (B, Sq, H, hd) bf16, lse (B, Sq, H) fp32; cap <= 0 means no
// softcap, window <= 0 no window; Skv >= 1 (a tensor map needs a
// non-empty tensor). hd 8, 12 and 16 take the mma.sync route, 64, 80 and
// 128 the wgmma one (hd 64 at the height hop::pick_rows gives). Returns
// cudaGetLastError() after the launch, -1 when the tensor maps cannot be
// built and -2 for a head dim no route takes.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int Sq, int Skv, int H, int K,
                        int hd, float scale, float cap, int causal,
                        int window, int q_offset, void* stream) {
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, o, lse, B, Sq, Skv, H, K, scale, cap, causal, window, \
             q_offset, st
  switch (hd) {
    case 8: return launch_mma<8>(ARGS);
    case 12: return launch_mma<12>(ARGS);
    case 16: return launch_mma<16>(ARGS);
    case 64:
      return hop::pick_rows(B, Sq, H) == 128 ? hop::launch<64, 2>(ARGS)
                                             : hop::launch<64, 1>(ARGS);
    case 80: return hop::launch<80, 2>(ARGS);
    case 128: return hop::launch<128, 2>(ARGS);
    default: return -2;
  }
#undef ARGS
}

}  // extern "C"
