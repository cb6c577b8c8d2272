// Mamba2 chunked SSD scan for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py:ssd (_ssd_kernel).
// For every (sequence, head) and every chunk of Q rows, with dA = dt * A
// (<= 0) and cs = cumsum(dA) over the chunk:
//   y_i     = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) (dt_j x_j)
//             + exp(cs_i) (C_i . state)
//   state' = exp(cs_{Q-1}) state + sum_j (dt_j x_j) exp(cs_{Q-1} - cs_j) B_j
// starting from h0 (zeros when null); y is stored in bf16, the last state
// in fp32. Head h reads B/C group h / (nh / G) (the TPU kernel's bc_index).
// x (b, S, nh, hp) bf16; dt (b, S, nh) fp32; A (nh,) fp32; B, C (b, S, G,
// N) bf16 with any batch and row strides (a group's N values dense, as
// slices of the conv output are); h0, h_last (b, nh, hp, N) fp32; y (b, S,
// nh, hp) bf16.
//
// What bounds it on this card: at mamba2_370m's serving chunk (b = 1,
// S = Q = 256, nh = 32, hp = 64, N = 128, G = 1) one call moves ~4.3 MB
// (x, y, h0, h_last): 1.3 us at 3.35 TB/s; its products are ~0.8 GFLOP
// with the fp32 operands in two bf16 parts, ~1.7 us at half mma.sync's
// peak. An earlier version on the fp32 CUDA cores, which recomputed C B^T
// for every head and column slice, took 0.171 ms on the device.
//
// What this design does (tools/ssd_ab.py and chip_smoke.py phase 2c,
// NVIDIA H100 80GB HBM3, 700.00 W: 0.0162-0.0182 ms on the device at
// mamba2's widths, 0.0251-0.0259 at zamba2's; see PERF.md):
//
// Every product is an mma.sync m16n8k16 with bf16 operands and fp32 sums.
// B, C and x are bf16, so a product with them as both operands (C B^T) is
// exact; the three products with an fp32 operand keep the bf16 operand
// whole and fold dt and the decays into the other one, which enters as two
// bf16 parts (split2: v to 16 bits):
//   y  = exp(cs_i) (C (h_hi + h_lo)^T) + (P_hi + P_lo) x,
//        P_ij = j <= i ? (C_i . B_j) exp(cs_i - cs_j) dt_j : 0 (a select:
//        above the diagonal exp overflows and inf * 0 is NaN); off the
//        diagonal 16-key step exp(cs_i - cs_m) exp(cs_m - cs_j), m the
//        step's last key, both factors <= 1: two exps a row and step in
//        place of one per score;
//   h' = exp(cs_{Q-1}) h + x^T (W_hi + W_lo),
//        W_jn = dt_j exp(cs_{Q-1} - cs_j) B_jn,
// with exp(cs_{Q-1}) h as the accumulator the products add into.
//
// Each chunk is two launches (the host function loops over the chunks,
// the state carried between them through h_last and a scratch state):
//  * prep: C B^T once per (sequence, group), over the causal 64 x 64
//    tiles, into an fp32 scratch the wrapper allocates (256 KiB at Q =
//    256, read back from L2). Once per group and not per head: with G = 1
//    every head shares it (32 heads in mamba2, 80 in zamba2). A scratch,
//    not a per-block recomputation, because a y block would need all of
//    B's rows up to its diagonal (64 KiB more shared memory) to make its
//    own.
//  * main, launched to start while prep runs (programmatic dependent
//    launch): state blocks (sequence, head, 64 hp x 64 N slice; a warp per
//    8 N columns) and y blocks (sequence, head, 64 rows x 64 hp columns,
//    longest row tiles first; warps 0-3 compute the read-out and the first
//    part of each 16-row strip's 16-key steps, warps 4-7 the rest, the two
//    sums added in that order). 2 x 8 warps an SM; 192 blocks at mamba2's
//    widths, 400 at zamba2's (two waves). Blocks copy B, C and x with
//    cp.async: state blocks in 64-row groups, working on one while the
//    next arrive; y blocks all at once, converting the state into its
//    bf16 parts and computing the read-out before they wait for prep.
//    Each block computes the chunk's cumsum itself: one warp, 8 rows a
//    lane in order, then a shuffle scan over the lanes in a fixed tree.
//
// What holds it back (timestamps in probe builds, which are not kept, so
// no numbers here): every block loads its inputs at once at the start,
// ~19 MB from L2 in all at mamba2's widths by count (each head's x and
// state read by 4 y and 2 state blocks, B and C by every head, C B^T by
// every y block), about a third of the time; then the longest strip's
// 16-key steps, where neither the products, the C B^T loads nor the
// diagonal step's exps dominate alone; prep overlaps the loads.
//
// Invariants. Every sum has one order, fixed by the row and column
// positions and Q alone (not by S, b or the grid), and a chunk's launches
// read only that chunk and the state before it: so a launch over 2Q rows
// equals two launches of Q with the state carried, bit for bit. A row j
// with dt_j = 0 enters every product through an exact zero (P_ij for
// i < j by the select, W_jn = 0 * ...), and mma.sync adds exact zeros
// without changing the accumulator: such rows leave h_last and the other
// rows' y unchanged whatever x, B and C hold, and a chunk of them leaves
// the state as it was (exp(0) = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kT = 64;         // tile edge: y rows, hp and N slices, C B^T
constexpr int kPad = 8;        // bf16 row pad: 16 bytes, no ldmatrix conflicts
constexpr int kRedS = kT + 4;  // fp32 row stride of the y blocks' reduction
constexpr int kMaxQ = 256;
constexpr int kMaxN = 256;

struct Args {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  long long sbB, ssB, sbC, ssC;  // batch and row strides of B and C
  const float* h_in;             // the state before the chunk; null: zeros
  __nv_bfloat16* y;
  float* h_out;                  // the state after it
  float* cb;                     // (b, G, QT, QT) scratch: C B^T
  int b, S, nh, hp, G, N, Q, t0; // t0: the chunk's first row
};

__host__ __device__ constexpr int up(int v, int m) {
  return (v + m - 1) / m * m;
}

// (v0, v1) as bf16 hi + lo parts, each pair packed with v0 in the low
// half: hi = v truncated to bf16 (its top 16 bits), lo = v - hi (exact in
// fp32) truncated too, so hi + lo holds v to 16 bits (relative error below
// 2^-15); byte permutes, no conversions
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(v0), u1 = __float_as_uint(v1);
  hi = __byte_perm(u0, u1, 0x7632);
  const float l0 = __fsub_rn(v0, __uint_as_float(u0 & 0xffff0000u));
  const float l1 = __fsub_rn(v1, __uint_as_float(u1 & 0xffff0000u));
  lo = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
}

// cp.async.wait_group with a count known only at run time (0..3)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// The main launch starts while the prep launch runs (programmatic
// dependent launch): a y block copies its inputs and computes the read-out,
// then waits here for the prep launch's C B^T.
__device__ __forceinline__ void wait_prep() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// `rows` rows of `vecs` 16-byte vectors (8 bf16 each; rows from live_rows
// and columns from live_cols on zero-filled) from src (row r at src + r *
// stride) into dst (row stride ds elements), by cp.async from the block.
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ds,
                                          const __nv_bfloat16* src,
                                          long long stride, int rows,
                                          int live_rows, int vecs,
                                          int live_cols) {
  for (int e = threadIdx.x; e < rows * vecs; e += kThreads) {
    const int r = e / vecs, v = e % vecs;
    const bool ok = r < live_rows && v * 8 < live_cols;
    cp_async16(dst + r * ds + v * 8, ok ? src + r * stride + v * 8 : src, ok);
  }
}

// The chunk's dt and cumsum of dt * A for one warp: lane l holds rows
// 8 l .. 8 l + 7 in dt[e] and cs[e] (rows from Q on: dt = 0, adding zeros).
// 8 rows a lane in order, then a shuffle scan over the lane totals in a
// fixed tree: every block of a head computes the same bits.
__device__ __forceinline__ void chunk_cumsum(const Args& a, int bi, int h,
                                             float (&dt)[8], float (&cs)[8]) {
  const int lane = threadIdx.x % 32;
  const float Ah = a.A[h];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int t = 8 * lane + e;
    dt[e] = t < a.Q ? a.dt[((size_t)bi * a.S + a.t0 + t) * a.nh + h] : 0.f;
  }
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float v = __fmul_rn(dt[e], Ah);
    run = e ? __fadd_rn(run, v) : v;
    cs[e] = run;
  }
  float inc = run;                   // inclusive scan of the lane totals
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const float o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc = __fadd_rn(o, inc);
  }
  const float ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane) {
#pragma unroll
    for (int e = 0; e < 8; ++e) cs[e] = __fadd_rn(ex, cs[e]);
  }
}

// ---------------------------------------------------------------------------
// prep: the causal C B^T tiles
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ssd_prep(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  asm volatile("griddepcontrol.launch_dependents;\n");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int QT = up(a.Q, kT);
  // one causal 64 x 64 tile (ti, tj <= ti) of C B^T for (sequence, group);
  // warp w: rows 16 (w % 4) .. + 16, columns 32 (w / 4) .. + 32
  const int T = QT / kT, ntile = T * (T + 1) / 2;
  int bid = blockIdx.x;
  const int tile = bid % ntile;
  bid /= ntile;
  const int g = bid % a.G, bi = bid / a.G;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int tj = tile - ti * (ti + 1) / 2;

  const int NK = up(a.N, 16), RS = NK + kPad;
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem);  // 64 x RS
  __nv_bfloat16* Bs = Cs + kT * RS;                             // 64 x RS
  const size_t row0 = (size_t)a.t0;
  copy_rows(Cs, RS, a.C + bi * a.sbC + (row0 + ti * kT) * a.ssC + g * a.N,
            a.ssC, kT, a.Q - ti * kT, NK / 8, a.N);
  copy_rows(Bs, RS, a.B + bi * a.sbB + (row0 + tj * kT) * a.ssB + g * a.N,
            a.ssB, kT, a.Q - tj * kT, NK / 8, a.N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int gq = lane / 4, tq = lane % 4;
  const int rw = 16 * (warp % 4), cw = 32 * (warp / 4);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < NK; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, Cs + (rw + (lane % 8) + ((lane / 8) % 2) * 8) * RS + k0 +
                    (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, Bs + (cw + 16 * np + (lane % 8) + (lane / 16) * 8) * RS +
                      k0 + ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
  float* cb = a.cb + ((size_t)(bi * a.G + g) * QT + ti * kT + rw) * QT +
              tj * kT + cw;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = 8 * nt + 2 * tq;
    *reinterpret_cast<float2*>(cb + gq * QT + c) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(cb + (gq + 8) * QT + c) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// main: the state update and y
// ---------------------------------------------------------------------------

// h_out[p, n] for 64 p x 64 n of one (sequence, head); warp w owns the 8
// columns n0 + 8w .. + 8 over all 64 p (4 m-tiles).
__device__ __forceinline__ void state_block(const Args& a, int bid,
                                            unsigned char* smem) {
  const int nNB = (a.N + kT - 1) / kT, nPB = (a.hp + kT - 1) / kT;
  const int nb = bid % nNB;
  bid /= nNB;
  const int pb = bid % nPB;
  bid /= nPB;
  const int h = bid % a.nh, bi = bid / a.nh, g = h / (a.nh / a.G);
  const int n0 = nb * kT, p0 = pb * kT;
  const int QK = up(a.Q, 16), RS = kT + kPad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;

  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // QK x RS
  __nv_bfloat16* bs = xs + QK * RS;                             // QK x RS
  float* sc = reinterpret_cast<float*>(bs + QK * RS);           // QK
  float* csl = sc + QK;                                         // cs_last

  const size_t row0 = (size_t)bi * a.S + a.t0;
  const size_t xstr = (size_t)a.nh * a.hp;
  const __nv_bfloat16* xg = a.x + row0 * xstr + (size_t)h * a.hp + p0;
  const __nv_bfloat16* bg =
      a.B + bi * a.sbB + (size_t)a.t0 * a.ssB + g * a.N + n0;
  const int groups = (QK + kT - 1) / kT;
  for (int kg = 0; kg < 4; ++kg) {   // four commit groups, some empty
    if (kg < groups) {
      const int r0 = kg * kT, rows = min(kT, QK - r0);
      copy_rows(xs + r0 * RS, RS, xg + r0 * xstr, (long long)xstr, rows,
                a.Q - r0, kT / 8, a.hp - p0);
      copy_rows(bs + r0 * RS, RS, bg + r0 * a.ssB, a.ssB, rows, a.Q - r0,
                kT / 8, a.N - n0);
    }
    cp_async_commit();
  }

  // the accumulator starts as exp(cs_last) * h
  const int nw = n0 + 8 * warp;      // the warp's first column
  const bool live = nw < a.N;
  float acc[4][4];
  const float* hin = a.h_in + ((size_t)bi * a.nh + h) * a.hp * a.N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = p0 + 16 * mt + gq + 8 * hf, n = nw + 2 * tq;
      float2 v = make_float2(0.f, 0.f);
      if (a.h_in && p < a.hp && live)
        v = __ldg(reinterpret_cast<const float2*>(hin + (size_t)p * a.N + n));
      acc[mt][2 * hf] = v.x;
      acc[mt][2 * hf + 1] = v.y;
    }

  if (warp == 0) {                   // sc[j] = dt_j exp(cs_last - cs_j)
    float d[8], c[8];
    chunk_cumsum(a, bi, h, d, c);
    const int last = a.Q - 1;        // cs_last: lane last / 8, e last % 8
    float cl = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = __shfl_sync(0xffffffffu, c[e], last / 8);
      if (e == last % 8) cl = v;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = 8 * lane + e;
      if (t < QK) sc[t] = __fmul_rn(d[e], __expf(__fsub_rn(cl, c[e])));
    }
    if (lane == 0) *csl = cl;
  }
  __syncthreads();
  const float dec = __expf(*csl);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[mt][r] = __fmul_rn(dec, acc[mt][r]);

  for (int kg = 0; kg < groups; ++kg) {
    cp_async_wait_n(3 - kg);
    __syncthreads();
    const int kend = min(QK, (kg + 1) * kT);
    if (!live) continue;
#pragma unroll
    for (int k0 = kg * kT; k0 < kg * kT + kT; k0 += 16) {
      if (k0 >= kend) break;
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_t(af[mt], xs + (k0 + (lane % 8) + (lane / 16) * 8) * RS +
                              16 * mt + ((lane / 8) % 2) * 8);
      // B rows k0 .. + 16 of the warp's 8 columns (the pair's 16 loaded)
      uint32_t bf[4];
      ldsm_x4_t(bf, bs + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * RS +
                        16 * (warp / 2) + (lane / 16) * 8);
      const float s0 = sc[k0 + 2 * tq], s1 = sc[k0 + 2 * tq + 1];
      const float s8 = sc[k0 + 8 + 2 * tq], s9 = sc[k0 + 9 + 2 * tq];
      const uint32_t bw[2] = {warp % 2 ? bf[2] : bf[0],
                              warp % 2 ? bf[3] : bf[1]};
      uint32_t whi[2], wlo[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {   // b0 (rows k0 + 2t), b1 (+ 8)
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(&bw[r]);
        split2(__fmul_rn(__low2float(v), r ? s8 : s0),
               __fmul_rn(__high2float(v), r ? s9 : s1), whi[r], wlo[r]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        mma_bf16(acc[mt], af[mt], whi[0], whi[1]);
        mma_bf16(acc[mt], af[mt], wlo[0], wlo[1]);
      }
    }
  }

  if (!live) return;
  float* hout = a.h_out + ((size_t)bi * a.nh + h) * a.hp * a.N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = p0 + 16 * mt + gq + 8 * hf, n = nw + 2 * tq;
      if (p < a.hp)
        *reinterpret_cast<float2*>(hout + (size_t)p * a.N + n) =
            make_float2(acc[mt][2 * hf], acc[mt][2 * hf + 1]);
    }
}

// y for 64 rows x 64 hp columns of one (sequence, head). Warp w owns rows
// r0 + 16 (w % 4) .. + 16 over all 64 columns (8 n-tiles); of the strip's
// keys (up to its diagonal) warps 0-3 take the first half of the 16-key
// steps and the read-out, warps 4-7 the rest; the two sums are added in
// that order.
__device__ __forceinline__ void y_block(const Args& a, int bid,
                                        unsigned char* smem) {
  const int nPB = (a.hp + kT - 1) / kT, nRT = (a.Q + kT - 1) / kT;
  const int per = a.b * a.nh * nPB;
  const int rt = nRT - 1 - bid / per;  // the longest row tiles first
  bid %= per;
  const int pb = bid % nPB;
  bid /= nPB;
  const int h = bid % a.nh, bi = bid / a.nh, g = h / (a.nh / a.G);
  const int r0 = rt * kT, p0 = pb * kT;
  const int QK = up(a.Q, 16), QT = up(a.Q, kT), NK = up(a.N, 16);
  const int RS = kT + kPad, RN = NK + kPad;
  const int jend = min(QK, r0 + kT);   // keys up to the tile's diagonal
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int strip = warp % 4, half = warp / 4;

  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // QK x RS
  __nv_bfloat16* Cs = xs + QK * RS;                             // 64 x RN
  __nv_bfloat16* Hh = Cs + kT * RN;                             // 64 x RN
  __nv_bfloat16* Hl = Hh + kT * RN;                             // 64 x RN
  float* red = reinterpret_cast<float*>(Hl + kT * RN);          // 64 x kRedS
  float* css = red + kT * kRedS;                                // QK
  float* dts = css + QK;                                        // QK
  float* ejs = dts + QK;                                        // QK

  const size_t row0 = (size_t)bi * a.S + a.t0;
  const size_t xstr = (size_t)a.nh * a.hp;
  // the tile's C rows and x rows [0, jend), in one cp.async group
  copy_rows(Cs, RN, a.C + bi * a.sbC + ((size_t)a.t0 + r0) * a.ssC + g * a.N,
            a.ssC, kT, a.Q - r0, NK / 8, a.N);
  const __nv_bfloat16* xg = a.x + row0 * xstr + (size_t)h * a.hp + p0;
  copy_rows(xs, RS, xg, (long long)xstr, jend, a.Q, kT / 8, a.hp - p0);
  cp_async_commit();

  // the state as bf16 hi + lo parts, [p][n], 8 float4 loads in flight a
  // thread
  const float* hin = a.h_in + ((size_t)bi * a.nh + h) * a.hp * a.N;
  if (a.h_in) {
    const int n4 = NK / 4, all = kT * n4;
    for (int e0 = threadIdx.x; e0 < all; e0 += 8 * kThreads) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads, p = e / n4, n = 4 * (e % n4);
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < all && p0 + p < a.hp && n < a.N)
          v[u] = __ldg(reinterpret_cast<const float4*>(
              hin + (size_t)(p0 + p) * a.N + n));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kThreads, p = e / n4, n = 4 * (e % n4);
        if (e >= all) break;
        uint32_t hi0, lo0, hi1, lo1;
        split2(v[u].x, v[u].y, hi0, lo0);
        split2(v[u].z, v[u].w, hi1, lo1);
        *reinterpret_cast<uint2*>(Hh + p * RN + n) = make_uint2(hi0, hi1);
        *reinterpret_cast<uint2*>(Hl + p * RN + n) = make_uint2(lo0, lo1);
      }
    }
  }

  if (warp == 0) {                   // cs, dt and, for the steps off the
    float d[8], c[8];                // diagonal, dt_j exp(cs_m - cs_j), m
    chunk_cumsum(a, bi, h, d, c);    // the last key of j's step (<= 1)
    const float cm = __shfl_sync(0xffffffffu, c[7], lane | 1);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = 8 * lane + e;
      if (t < QK) {
        css[t] = c[e];
        dts[t] = d[e];
        ejs[t] = __fmul_rn(d[e], __expf(__fsub_rn(cm, c[e])));
      }
    }
  }

  const int ia = r0 + 16 * strip + gq, ib = ia + 8;  // the thread's rows
  // the strip's 16-key steps [0, nk): warps 0-3, which also compute the
  // read-out (about NK / 32 steps' work), take [0, m), warps 4-7 the rest
  const int nk = min(QK, r0 + 16 * strip + 16) / 16;
  const int m = max(0, (nk - (a.h_in ? NK / 32 : 0)) / 2);
  const int kt0 = half ? m : 0, kt1 = half ? nk : m;
  const float* cbg = a.cb + (size_t)(bi * a.G + g) * QT * QT;
  const float* cba = cbg + (size_t)ia * QT;
  const float* cbb = cbg + (size_t)ib * QT;
  // C B^T for the thread's fragment of three steps: two fetched ahead
  float2 cv[3][4];
  auto fetch = [&](int kt, float2 (&d)[4]) {
    const int c = 16 * kt + 2 * tq;
    d[0] = __ldcg(reinterpret_cast<const float2*>(cba + c));
    d[1] = __ldcg(reinterpret_cast<const float2*>(cbb + c));
    d[2] = __ldcg(reinterpret_cast<const float2*>(cba + c + 8));
    d[3] = __ldcg(reinterpret_cast<const float2*>(cbb + c + 8));
  };

  float acc[8][4] = {};
  cp_async_wait<0>();                // C, x, the state's parts, cs
  __syncthreads();
  if (a.h_in && !half) {             // exp(cs_i) * (C_i . h)
    for (int k0 = 0; k0 < NK; k0 += 16) {
      uint32_t af[4];
      ldsm_x4(af, Cs + (16 * strip + (lane % 8) + ((lane / 8) % 2) * 8) * RN +
                      k0 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int off = (16 * np + (lane % 8) + (lane / 16) * 8) * RN + k0 +
                        ((lane / 8) % 2) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, Hh + off);
        ldsm_x4(bl, Hl + off);
        mma_bf16(acc[2 * np], af, bh[0], bh[1]);
        mma_bf16(acc[2 * np], af, bl[0], bl[1]);
        mma_bf16(acc[2 * np + 1], af, bh[2], bh[3]);
        mma_bf16(acc[2 * np + 1], af, bl[2], bl[3]);
      }
    }
    const float ea = ia < jend ? __expf(css[ia]) : 0.f;
    const float eb = ib < jend ? __expf(css[ib]) : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] = __fmul_rn(ea, acc[nt][0]);
      acc[nt][1] = __fmul_rn(ea, acc[nt][1]);
      acc[nt][2] = __fmul_rn(eb, acc[nt][2]);
      acc[nt][3] = __fmul_rn(eb, acc[nt][3]);
    }
  }

  // + sum_j P_ij x_j over the warp's steps, from the prep launch's C B^T
  wait_prep();
  if (kt0 < kt1) fetch(kt0, cv[0]);
  if (kt0 + 1 < kt1) fetch(kt0 + 1, cv[1]);
  const float csa = ia < jend ? css[ia] : 0.f;
  const float csb = ib < jend ? css[ib] : 0.f;
  // one step: C B^T of step kt in cbv; step kt + 2's fetched into `ahead`
  auto step = [&](int kt, const float2 (&cbv)[4], float2 (&ahead)[4]) {
    if (kt + 2 < kt1) fetch(kt + 2, ahead);
    const int k0 = 16 * kt;
    uint32_t phi[4], plo[4];
    if (kt == nk - 1) {            // the diagonal step: a select per key
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // a0: (ia, c), a1: (ib, c), a2/3: c + 8
        const int j = k0 + 2 * tq + 8 * (q / 2);
        const int i = q % 2 ? ib : ia;
        const float ci = q % 2 ? csb : csa;
        const float2 v = cbv[q];
        const float p0v = j <= i
            ? __fmul_rn(__fmul_rn(v.x, __expf(__fsub_rn(ci, css[j]))),
                        dts[j])
            : 0.f;
        const float p1v = j + 1 <= i
            ? __fmul_rn(__fmul_rn(v.y, __expf(__fsub_rn(ci, css[j + 1]))),
                        dts[j + 1])
            : 0.f;
        split2(p0v, p1v, phi[q], plo[q]);
      }
    } else {                       // every key before every row:
      // exp(cs_i - cs_j) = exp(cs_i - cs_m) exp(cs_m - cs_j), both <= 1
      const float cm = css[k0 + 15];
      const float ra = __expf(__fsub_rn(csa, cm));
      const float rb = __expf(__fsub_rn(csb, cm));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = k0 + 2 * tq + 8 * (q / 2);
        const float r = q % 2 ? rb : ra;
        const float2 v = cbv[q];
        split2(__fmul_rn(__fmul_rn(v.x, r), ejs[j]),
               __fmul_rn(__fmul_rn(v.y, r), ejs[j + 1]), phi[q], plo[q]);
      }
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bx[4];
      ldsm_x4_t(bx, xs + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * RS +
                        16 * np + (lane / 16) * 8);
      mma_bf16(acc[2 * np], phi, bx[0], bx[1]);
      mma_bf16(acc[2 * np], plo, bx[0], bx[1]);
      mma_bf16(acc[2 * np + 1], phi, bx[2], bx[3]);
      mma_bf16(acc[2 * np + 1], plo, bx[2], bx[3]);
    }
  };
  // three steps a round, so the fetched registers rotate by name
  for (int kt = kt0; kt < kt1; kt += 3) {
    step(kt, cv[0], cv[2]);
    if (kt + 1 < kt1) step(kt + 1, cv[1], cv[0]);
    if (kt + 2 < kt1) step(kt + 2, cv[2], cv[1]);
  }

  // warps 4-7 hand their sums to warps 0-3
  const int ra = 16 * strip + gq;
  if (half) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(red + ra * kRedS + c) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(red + (ra + 8) * kRedS + c) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();
  if (half) return;
  __nv_bfloat16* yg = a.y + row0 * xstr + (size_t)h * a.hp + p0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = 8 * nt + 2 * tq;
    if (p0 + c >= a.hp) continue;
    const float2 ua = *reinterpret_cast<const float2*>(red + ra * kRedS + c);
    const float2 ub =
        *reinterpret_cast<const float2*>(red + (ra + 8) * kRedS + c);
    if (ia < a.Q)
      *reinterpret_cast<__nv_bfloat162*>(yg + ia * xstr + c) =
          __floats2bfloat162_rn(__fadd_rn(acc[nt][0], ua.x),
                                __fadd_rn(acc[nt][1], ua.y));
    if (ib < a.Q)
      *reinterpret_cast<__nv_bfloat162*>(yg + ib * xstr + c) =
          __floats2bfloat162_rn(__fadd_rn(acc[nt][2], ub.x),
                                __fadd_rn(acc[nt][3], ub.y));
  }
}

__global__ void __launch_bounds__(kThreads, 2) ssd_main(const Args a,
                                                        int state_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < state_blocks)
    state_block(a, blockIdx.x, smem);
  else
    y_block(a, blockIdx.x - state_blocks, smem);
}

size_t prep_smem(int N) { return 2 * (size_t)kT * (up(N, 16) + kPad) * 2; }

size_t main_smem(int Q, int N) {
  const size_t QK = up(Q, 16), rs = kT + kPad, rn = up(N, 16) + kPad;
  const size_t st = 2 * QK * rs * 2 + 2 * QK * 4;
  const size_t yb = QK * rs * 2 + 3 * kT * rn * 2 + kT * kRedS * 4 +
                    3 * QK * 4;
  return st > yb ? st : yb;
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// The scan over S rows in chunks of Q (S a multiple of Q, Q <= 256; hp a
// multiple of 16, N of 8 and at most 256, nh of G). B and C take any batch
// and row strides (sbB, ssB, sbC, ssC, in elements; multiples of 8 where
// used). h0 may be null (zeros). Scratch from the caller: cb (b, G, QT, QT)
// fp32 (QT = Q rounded up to 64) and, when S > Q, h_tmp (b, nh, hp, N)
// fp32. S == 0 copies h0 (or zeros) into
// h_last. Returns the first CUDA error of the launches, or
// cudaErrorInvalidValue for shapes the kernels do not take.
int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
             const void* C, long long sbB, long long ssB, long long sbC,
             long long ssC, const void* h0, void* y, void* h_last,
             void* h_tmp, void* cb, int b, int S, int nh, int hp,
             int G, int N, int Q, void* stream) {
  if (b < 0 || S < 0 || hp <= 0 || hp % 16 || N <= 0 || N % 8 ||
      N > kMaxN || G <= 0 || nh % G || Q < 1 || Q > kMaxQ || S % Q ||
      (S > Q && !h_tmp))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t state_bytes = (size_t)b * nh * hp * N * 4;
  if (b == 0 || nh == 0) return static_cast<int>(cudaGetLastError());
  if (S == 0) {
    const cudaError_t e =
        h0 ? cudaMemcpyAsync(h_last, h0, state_bytes,
                             cudaMemcpyDeviceToDevice, st)
           : cudaMemsetAsync(h_last, 0, state_bytes, st);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
  const size_t ps = prep_smem(N), ms = main_smem(Q, N);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(ssd_prep), ps);
  if (e == cudaSuccess)
    e = allow_smem(reinterpret_cast<const void*>(ssd_main), ms);
  if (e != cudaSuccess) return static_cast<int>(e);

  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = static_cast<const __nv_bfloat16*>(B);
  a.C = static_cast<const __nv_bfloat16*>(C);
  a.sbB = sbB;
  a.ssB = ssB;
  a.sbC = sbC;
  a.ssC = ssC;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.cb = static_cast<float*>(cb);
  a.b = b;
  a.S = S;
  a.nh = nh;
  a.hp = hp;
  a.G = G;
  a.N = N;
  a.Q = Q;
  const int T = up(Q, kT) / kT;
  const int cb_blocks = b * G * T * (T + 1) / 2;
  const int nPB = (hp + kT - 1) / kT, nNB = (N + kT - 1) / kT;
  const int state_blocks = b * nh * nPB * nNB;
  const int main_blocks = state_blocks + b * nh * nPB * T;
  cudaLaunchAttribute early;         // main may start before prep ends
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(main_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = ms;
  cfg.stream = st;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  const float* h_in = static_cast<const float*>(h0);
  for (int c = 0; c < S / Q; ++c) {
    // the last chunk writes h_last; the others alternate with h_tmp
    float* h_out =
        static_cast<float*>((S / Q - 1 - c) % 2 ? h_tmp : h_last);
    a.t0 = c * Q;
    a.h_in = h_in;
    a.h_out = h_out;
    ssd_prep<<<cb_blocks, kThreads, ps, st>>>(a);
    e = cudaLaunchKernelEx(&cfg, ssd_main, a, state_blocks);
    if (e != cudaSuccess) return static_cast<int>(e);
    h_in = h_out;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
