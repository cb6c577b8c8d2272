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
// (68.7 GFLOP at B=2, S=2048, H=32: 0.0695 ms at 989 TFLOP/s).
//
// Route "wgmma" (hd 128, the training path), designed for Hopper:
//  * a block owns 128 query rows of one (batch, q head): two warpgroups of
//    64 rows. Query tiles are on the grid's slow axis, the last (longest
//    causal) tile first. There is no producer warp: a 288- or 384-thread
//    block is held to 168 registers a thread (the compiler does not give
//    the consumers setmaxnreg's 240 here), and the loop needs 254;
//  * one thread loads Q once and each 128-key tile of K and V with TMA
//    (cp.async.bulk.tensor over the (hd, heads, S, B) view of the (B, S,
//    heads, hd) tensors; a 128-wide row is two 128-byte boxes) into a
//    3-stage ring of 128B-swizzled tiles, two tiles ahead of their use,
//    with mbarrier completion and release. TMA fills rows past Sq and Skv
//    with zeros; keys past Skv are masked all the same, since a zero score
//    is not -1e30;
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major, 8 k-steps); O += P V is wgmma m64n128k16 with P from
//    registers (the scores' accumulator layout is the A-fragment layout
//    once P is rounded to bf16) and V read through the transpose bit. Per
//    tile a warpgroup issues S(j) and P(j-1) V(j-1) together and runs the
//    softmax of S(j) while P V runs;
//  * the softmax runs in base 2 (scale and log2 e in one multiply, ex2 on
//    the special-function unit); only tiles on the diagonal, the window's
//    edge or the Skv edge are masked, branch-free, against per-row key
//    bounds. The scores stay fp32 (bf16 products are exact in fp32); P
//    enters P V rounded to bf16, while l sums fp32;
//  * the output is scaled by 1 / l, staged in the warpgroup's own rows of
//    the Q tile (swizzled as the boxes are) and written by TMA, which
//    leaves out rows past Sq.
// Routes "mma" (hd 16, the smoke configs), "mma64" (hd 64, whisper's
// encoder, cross and static prefill attention) and "mma80" (hd 80,
// zamba2's shared attention block): one template, 4 warps own
// 64 rows, each 64-key tile is copied to shared memory with 16-byte loads
// (one plain load, no ring: a simple first kernel for hd 64 and 80), and both
// products are mma.sync m16n8k16 with fp32 accumulation. At whisper's
// non-causal 1500 x 1500 the work is 4 hd flops per (row, key) pair, so
// this route too is bound by operations on the card.
// In every route, every sum has one fixed order (no atomics, no split over keys),
// so two launches on the same inputs give the same bits: remat's
// recompute of the forward reproduces it exactly.

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, wgmma descriptors and fences, ex2
#include "mma.cuh"     // mma_bf16, pack_bf16

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// routes "mma" (hd 16), "mma64" (hd 64) and "mma80" (hd 80)
// ---------------------------------------------------------------------------

constexpr int BQ = 64;          // query rows per block, 16 per warp
constexpr int BKV = 64;         // keys per tile
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_halves(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// m16n8k16 fragments as mma.cuh lays them out.
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

// ---------------------------------------------------------------------------
// route "wgmma": hd 128
// ---------------------------------------------------------------------------

namespace hop {

constexpr int HD = 128;
constexpr int BQ = 128;                    // query rows per block
constexpr int BKV = 128;                   // keys per tile
constexpr int STAGES = 3;                  // K/V ring depth
constexpr int THREADS = 256;               // two warpgroups of 64 rows
constexpr int BOX_BYTES = BKV * 64 * 2;    // 128 rows x 64 values (128 B)
constexpr int TILE_BYTES = 2 * BOX_BYTES;  // 128 rows x 128 values
constexpr int WG_ROWS_BYTES = 64 * 128;    // a warpgroup's 64 rows of a box
// shared memory, from a 1024-byte aligned base (the 128B swizzle repeats
// every 8 rows of 128 bytes): Q, K[STAGES], V[STAGES], then the barriers
constexpr int SM_Q = 0;
constexpr int SM_K = SM_Q + TILE_BYTES;
constexpr int SM_V = SM_K + STAGES * TILE_BYTES;
constexpr int SM_BAR = SM_V + STAGES * TILE_BYTES;
constexpr int SM_BYTES = SM_BAR + 8 * (1 + 4 * STAGES) + 1024;

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

// Keeps the compiler from moving reads of an accumulator across a wait.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC64(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define ACC64_STR                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                    \
  "%8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, "             \
  "%24, %25, %26, %27, %28, %29, %30, %31, "             \
  "%32, %33, %34, %35, %36, %37, %38, %39, "             \
  "%40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, "             \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, fp32) = or += a (64 x 16) * b (16 x 128), both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64_STR
      ", %64, %65, p, 1, 1, 0, 0;\n\t}"
      : ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, fp32) += a (64 x 16, bf16 fragments in registers) * b
// (16 x 128), b MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64_STR
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Keeps the compiler from reusing P's registers while a wgmma reads them.
__device__ __forceinline__ void pin(uint32_t (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(r[i])::"memory");
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

// Per tile j each warpgroup issues S(j) = Q K(j)^T, rescales O (the
// CUDA cores, while S(j) runs), issues O += P(j-1) V(j-1), waits for S(j)
// alone and runs its softmax while the tensor cores finish P V. One thread of
// warpgroup 0 also issues the TMA loads, two tiles ahead: K(j + 2) and
// V(j + 1) in tile j, each into the stage its predecessor three tiles back
// has left (both warpgroups released it a tile ago, so the wait is
// normally over). All 256 threads compute: no producer warps, so each
// thread may hold 255 registers.
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(__grid_constant__ const CUtensorMap qmap,
                __grid_constant__ const CUtensorMap kmap,
                __grid_constant__ const CUtensorMap vmap,
                __grid_constant__ const CUtensorMap omap,
                float* __restrict__ lse,
                int Sq, int Skv, int H, int K, float scale, float cap,
                int causal, int window, int q_offset) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base + SM_Q, k_s = base + SM_K, v_s = base + SM_V;
  // barriers: q_full, then per stage k_full, v_full, k_empty, v_empty
  const uint32_t q_full = base + SM_BAR;
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

  const bool loader = threadIdx.x == 0;
  // tile j of K (or V) into stage j % STAGES, once tile j - STAGES has left
  auto load_k = [&](int j) {
    const int s = j % STAGES, kv0 = (tile_lo + j) * BKV;
    if (j >= STAGES) mbar_wait(k_empty(s), ((j / STAGES) - 1) & 1);
    mbar_expect_tx(k_full(s), TILE_BYTES);
    tma_load(k_s + s * TILE_BYTES, &kmap, k_full(s), 0, kh, kv0, b);
    tma_load(k_s + s * TILE_BYTES + BOX_BYTES, &kmap, k_full(s), 64, kh, kv0,
             b);
  };
  auto load_v = [&](int j) {
    const int s = j % STAGES, kv0 = (tile_lo + j) * BKV;
    if (j >= STAGES) mbar_wait(v_empty(s), ((j / STAGES) - 1) & 1);
    mbar_expect_tx(v_full(s), TILE_BYTES);
    tma_load(v_s + s * TILE_BYTES, &vmap, v_full(s), 0, kh, kv0, b);
    tma_load(v_s + s * TILE_BYTES + BOX_BYTES, &vmap, v_full(s), 64, kh, kv0,
             b);
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
    mbar_expect_tx(q_full, TILE_BYTES);
    tma_load(q_s, &qmap, q_full, 0, h, q0, b);
    tma_load(q_s + BOX_BYTES, &qmap, q_full, 64, h, q0, b);
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
  auto issue_s = [&](float (&sc)[64], uint32_t kt) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
      wgmma_ss(sc, sdesc(q_s + off + wg * WG_ROWS_BYTES, 16, 1024),
               sdesc(kt + off, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  auto issue_pv = [&](float (&acc)[64], const uint32_t (&pa)[32],
                      uint32_t vt) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs(acc, pa + 4 * kk, sdesc(vt + kk * 2048, BOX_BYTES, 1024));
    wg_commit();
  };
  // the loads tile j issues: K(j + 2) and V(j + 1)
  auto prefetch = [&](int j) {
    if (!loader) return;
    if (j + 2 < n_tiles) load_k(j + 2);
    if (j + 1 < n_tiles) load_v(j + 1);
  };

  auto rescale = [&](float (&acc)[64], const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= corr[(i >> 1) & 1];
  };

  float acc[64], sc[64], corr[2];
  uint32_t pa[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
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
    issue_s(sc, k_s + s * TILE_BYTES);
    rescale(acc, corr);
    pin(acc);
    wg_fence();
    issue_pv(acc, pa, v_s + ps * TILE_BYTES);
    prefetch(it);
    wg_wait<1>();
    pin(sc);
    mbar_arrive(k_empty(s));
    softmax(sc, m, l, corr, kv0, need_mask(kv0));
    wg_wait<0>();
    pin(acc);
    pin(pa);
    mbar_arrive(v_empty(ps));
    pack_p(sc, pa);
    pin(pa);
  }
  if (n_tiles > 0) {
    const int ps = (n_tiles - 1) % STAGES;
    mbar_wait(v_full(ps), ((n_tiles - 1) / STAGES) & 1);
    rescale(acc, corr);
    pin(acc);
    wg_fence();
    issue_pv(acc, pa, v_s + ps * TILE_BYTES);
    wg_wait<0>();
    pin(acc);
  }

  // each thread summed its own columns: combine the quad in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // o = acc / l in bf16, written into this warpgroup's 64 rows of the Q
  // tiles (free once its last S product is done), 128B-swizzled as the
  // boxes are, then stored by TMA, which leaves out rows past Sq
  const uint32_t o_s = q_s + wg * WG_ROWS_BYTES;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ll = fmaxf(l[r], 1e-37f), inv = 1.f / ll;
    const int rr = 16 * (tid >> 5) + g + 8 * r;  // row within the 64
#pragma unroll
    for (int j = 0; j < 16; ++j)
      st_shared(o_s + (j >> 3) * BOX_BYTES + rr * 128 +
                    (((j & 7) ^ (rr & 7)) << 4) + 4 * t,
                pack_bf16(acc[4 * j + 2 * r] * inv,
                          acc[4 * j + 2 * r + 1] * inv));
    if (t == 0 && row + 8 * r < Sq)
      lse[(size_t)(b * Sq + row + 8 * r) * H + h] = m[r] * LN2 + logf(ll);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  wg_bar_sync(1 + wg);
  if (tid == 0) {
    tma_store(&omap, o_s, 0, h, q0 + 64 * wg, b);
    tma_store(&omap, o_s + BOX_BYTES, 64, h, q0 + 64 * wg, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

#undef ACC64
#undef ACC64_STR

// A (B, S, N, 128) bf16 tensor seen as (128, N, S, B), boxes of 64 values x
// 1 head x `rows` rows, 128B-swizzled; rows past S read as zeros and are
// not written.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B, int S,
            int N, int rows) {
  const cuuint64_t dims[4] = {HD, (cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * 2ull, (cuuint64_t)N * HD * 2,
                                 (cuuint64_t)S * N * HD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hop

// The mma.sync routes on `stream`.
template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Sq, int Skv, int H, int K, float scale,
               float cap, int causal, int window, int q_offset,
               void* stream) {
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_fwd_kernel<HD><<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Skv, H, K, scale, cap, causal, window,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The entry points: q (B, Sq, H, hd), k/v (B, Skv, K, hd) bf16 contiguous
// -> o (B, Sq, H, hd) bf16, lse (B, Sq, H) fp32; cap <= 0 means no
// softcap, window <= 0 no window. They return cudaGetLastError() after the
// launch.

// Route "mma", hd 16.
int flash_attention_fwd_mma(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int Sq, int Skv, int H,
                            int K, float scale, float cap, int causal,
                            int window, int q_offset, void* stream) {
  return launch_mma<16>(q, k, v, o, lse, B, Sq, Skv, H, K, scale, cap,
                        causal, window, q_offset, stream);
}

// Route "mma64", hd 64.
int flash_attention_fwd_mma64(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Skv,
                              int H, int K, float scale, float cap,
                              int causal, int window, int q_offset,
                              void* stream) {
  return launch_mma<64>(q, k, v, o, lse, B, Sq, Skv, H, K, scale, cap,
                        causal, window, q_offset, stream);
}

// Route "mma80", hd 80 (zamba2's shared attention block): 5 k-steps of
// q k^T, 10 eight-column output tiles, 176-byte padded shared rows.
int flash_attention_fwd_mma80(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Skv,
                              int H, int K, float scale, float cap,
                              int causal, int window, int q_offset,
                              void* stream) {
  return launch_mma<80>(q, k, v, o, lse, B, Sq, Skv, H, K, scale, cap,
                        causal, window, q_offset, stream);
}

// Route "wgmma", hd 128; Skv >= 1 (a tensor map needs a non-empty tensor).
// Returns -1 when the tensor maps cannot be built.
int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Skv,
                              int H, int K, float scale, float cap,
                              int causal, int window, int q_offset,
                              void* stream) {
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  EncodeTiled fn = encode_tiled();
  CUtensorMap qm, km, vm, om;
  if (fn == nullptr || !hop::encode(fn, &qm, q, B, Sq, H, hop::BQ) ||
      !hop::encode(fn, &km, k, B, Skv, K, hop::BKV) ||
      !hop::encode(fn, &vm, v, B, Skv, K, hop::BKV) ||
      !hop::encode(fn, &om, o, B, Sq, H, 64))
    return -1;
  cudaError_t e = cudaFuncSetAttribute(
      hop::flash_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      hop::SM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B * H, (Sq + hop::BQ - 1) / hop::BQ);
  hop::flash_fwd_wgmma<<<grid, hop::THREADS, hop::SM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, om, static_cast<float*>(lse), Sq, Skv, H, K, scale, cap,
      causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
