// Mamba2 chunked SSD scan for Hopper (sm_90a).
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
// N) bf16; h0, h_last (b, nh, hp, N) fp32; y (b, S, nh, hp) bf16.
//
// What bounds it on this card: at mamba2_370m's serving chunk (S = Q = 256,
// nh = 32, hp = 64, N = 128) the call moves ~4.2 MB (x, y, h0, h_last) and
// does ~1.1 GFLOP, so both bounds sit near 1.3 us; this kernel computes in
// fp32 on the CUDA cores (67 TFLOP/s), where the same work needs ~16 us.
//
// What this design does about it (first, simple version):
//  * The TPU keeps a Q x Q fp32 score tile (256 KiB) in VMEM. Here one
//    block's shared memory holds the chunk's B and C rows (bf16), x * dt
//    for its state columns, and one strip of scores: 32 query rows against
//    the key rows up to the diagonal. Tiles above the diagonal are skipped.
//  * The TPU's chunk axis is a sequential grid dimension with the state in
//    VMEM scratch; here the chunk loop runs inside the block and the
//    (16 x N) state slice lives in shared memory.
//  * One block per (sequence, head) would give 32 blocks for mamba2_370m's
//    one-sequence chunk row on 132 SMs. Columns of x, y and the state are
//    independent, so each block owns 16 of the hp columns and recomputes
//    C B^T . L for them (4 blocks per head at hp = 64).
//  * Every sum runs in one fixed order with explicitly rounded operations
//    (the cumsum sequential in fp32 by one thread, dot products over n and
//    over j in ascending order), independent of launch shape. So a launch
//    over 2Q rows equals two launches of Q with the state carried, bit for
//    bit, and trailing rows with dt = 0 add exact zeros: they leave h_last
//    and the earlier rows' y unchanged, bit for bit.
// No tensor cores, no TMA and no double buffering: later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 16;      // state / x / y columns (of hp) per block
constexpr int kRT = 32;      // query rows per score strip
constexpr int kMaxQ = 256;

struct Args {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  const float* h0;           // null: zeros
  __nv_bfloat16* y;
  float* h_last;
  int S, nh, hp, G, N, Q;
};

size_t smem_bytes(int Q, int N) {
  const size_t ns = N + 2;   // padded bf16 row: an odd word stride
  return 2 * Q * ns * 2 + (size_t)Q * kPT * 4 + 3 * (size_t)Q * 4 +
         (size_t)kPT * (N + 1) * 4 + (size_t)kRT * (Q + 1) * 4;
}

__global__ void __launch_bounds__(kThreads) ssd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = a.Q, N = a.N, NS = N + 2, nh = a.nh, hp = a.hp;
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem);   // Q x NS
  __nv_bfloat16* Cs = Bs + Q * NS;                              // Q x NS
  float* xdt = reinterpret_cast<float*>(Cs + Q * NS);           // Q x kPT
  float* cs = xdt + Q * kPT;         // dt, then the cumsum of dt * A
  float* ecs = cs + Q;               // exp(cs_i)
  float* ew = ecs + Q;               // exp(cs_{Q-1} - cs_j)
  float* st = ew + Q;                // kPT x (N + 1): the state slice
  float* Ss = st + kPT * (N + 1);    // kRT x (Q + 1): one score strip

  const int tid = threadIdx.x;
  const int n_pt = hp / kPT;
  int bid = blockIdx.x;
  const int p0 = (bid % n_pt) * kPT;
  bid /= n_pt;
  const int h = bid % nh;
  const int bi = bid / nh;
  const int g = h / (nh / a.G);
  const float Ah = a.A[h];
  const size_t st_base = ((size_t)bi * nh + h) * hp + p0;   // (b, h, p0) row

  for (int e = tid; e < kPT * N; e += kThreads) {
    const int p = e / N, n = e % N;
    st[p * (N + 1) + n] = a.h0 ? a.h0[(st_base + p) * N + n] : 0.f;
  }

  const int nc = a.S / Q;
  const int vecs = N / 8;            // 16-byte vectors per B / C row
  for (int c = 0; c < nc; ++c) {
    const size_t t0 = (size_t)bi * a.S + (size_t)c * Q;   // flat row of t=0
    __syncthreads();                 // the previous chunk is consumed
    for (int i = tid; i < 2 * Q * vecs; i += kThreads) {
      const int which = i / (Q * vecs), rem = i % (Q * vecs);
      const int t = rem / vecs, v = rem % vecs;
      const __nv_bfloat16* src =
          (which ? a.C : a.B) + ((t0 + t) * a.G + g) * N;
      const uint4 val = reinterpret_cast<const uint4*>(src)[v];
      uint32_t* dst = reinterpret_cast<uint32_t*>((which ? Cs : Bs) +
                                                  t * NS + v * 8);
      dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
    }
    for (int t = tid; t < Q; t += kThreads) cs[t] = a.dt[(t0 + t) * nh + h];
    __syncthreads();
    for (int e = tid; e < Q * kPT; e += kThreads) {
      const int t = e / kPT, p = e % kPT;
      const float xv = __bfloat162float(a.x[((t0 + t) * nh + h) * hp + p0 + p]);
      xdt[e] = __fmul_rn(xv, cs[t]);
    }
    __syncthreads();                 // every read of dt is done
    if (tid == 0) {                  // sequential fp32 cumsum
      float run = 0.f;
      for (int t = 0; t < Q; ++t) {
        run = __fadd_rn(run, __fmul_rn(cs[t], Ah));
        cs[t] = run;
      }
    }
    __syncthreads();
    const float cs_last = cs[Q - 1];
    for (int t = tid; t < Q; t += kThreads) {
      ecs[t] = expf(cs[t]);
      ew[t] = expf(__fsub_rn(cs_last, cs[t]));
    }

    for (int r0 = 0; r0 < Q; r0 += kRT) {
      const int jend = min(Q, r0 + kRT);           // keys up to the diagonal
      __syncthreads();               // ecs / ew ready; the strip is free
      // score strip: Ss[i - r0][j] = (C_i . B_j) exp(cs_i - cs_j), j <= i,
      // in 32 x 32 tiles; thread (ti, tj) owns rows 2ti, 2ti+1 and
      // columns 2tj, 2tj+1 of a tile
      const int ti = tid / 16, tj = tid % 16;
      const int i0 = r0 + 2 * ti;
      const __nv_bfloat162* c0 = reinterpret_cast<const __nv_bfloat162*>(
          Cs + min(i0, Q - 1) * NS);
      const __nv_bfloat162* c1 = reinterpret_cast<const __nv_bfloat162*>(
          Cs + min(i0 + 1, Q - 1) * NS);
      for (int jb = 0; jb < jend; jb += 32) {
        const int j0 = jb + 2 * tj;
        const __nv_bfloat162* b0 = reinterpret_cast<const __nv_bfloat162*>(
            Bs + min(j0, Q - 1) * NS);
        const __nv_bfloat162* b1 = reinterpret_cast<const __nv_bfloat162*>(
            Bs + min(j0 + 1, Q - 1) * NS);
        float acc00 = 0.f, acc01 = 0.f, acc10 = 0.f, acc11 = 0.f;
        for (int n2 = 0; n2 < N / 2; ++n2) {
          const float2 ca = __bfloat1622float2(c0[n2]);
          const float2 cb = __bfloat1622float2(c1[n2]);
          const float2 ba = __bfloat1622float2(b0[n2]);
          const float2 bb = __bfloat1622float2(b1[n2]);
          acc00 = fmaf(ca.x, ba.x, acc00); acc00 = fmaf(ca.y, ba.y, acc00);
          acc01 = fmaf(ca.x, bb.x, acc01); acc01 = fmaf(ca.y, bb.y, acc01);
          acc10 = fmaf(cb.x, ba.x, acc10); acc10 = fmaf(cb.y, ba.y, acc10);
          acc11 = fmaf(cb.x, bb.x, acc11); acc11 = fmaf(cb.y, bb.y, acc11);
        }
        const float accs[2][2] = {{acc00, acc01}, {acc10, acc11}};
#pragma unroll
        for (int di = 0; di < 2; ++di) {
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            const int i = i0 + di, j = j0 + dj;
            if (i >= Q || j >= jend) continue;
            const float s = j <= i
                ? __fmul_rn(accs[di][dj], expf(__fsub_rn(cs[i], cs[j])))
                : 0.f;
            Ss[(i - r0) * (Q + 1) + j] = s;
          }
        }
      }
      __syncthreads();
      // y for the strip's rows and the block's columns
      for (int e = tid; e < kRT * kPT; e += kThreads) {
        const int r = e / kPT, p = e % kPT, i = r0 + r;
        if (i >= Q) continue;
        const float* srow = Ss + r * (Q + 1);
        float yi = 0.f;
        for (int j = 0; j <= i; ++j) yi = fmaf(srow[j], xdt[j * kPT + p], yi);
        const __nv_bfloat162* ci =
            reinterpret_cast<const __nv_bfloat162*>(Cs + i * NS);
        const float* sp = st + p * (N + 1);
        float yo = 0.f;
        for (int n2 = 0; n2 < N / 2; ++n2) {
          const float2 cv = __bfloat1622float2(ci[n2]);
          yo = fmaf(cv.x, sp[2 * n2], yo);
          yo = fmaf(cv.y, sp[2 * n2 + 1], yo);
        }
        const float yv = __fadd_rn(yi, __fmul_rn(ecs[i], yo));
        a.y[((t0 + i) * nh + h) * hp + p0 + p] = __float2bfloat16_rn(yv);
      }
    }
    __syncthreads();                 // every y read of the state is done
    const float dec = expf(cs_last);
    for (int e = tid; e < kPT * N; e += kThreads) {
      const int p = e / N, n = e % N;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j)
        acc = fmaf(__fmul_rn(xdt[j * kPT + p], ew[j]),
                   __bfloat162float(Bs[j * NS + n]), acc);
      float* sp = st + p * (N + 1) + n;
      *sp = __fadd_rn(__fmul_rn(dec, *sp), acc);
    }
  }
  __syncthreads();
  for (int e = tid; e < kPT * N; e += kThreads) {
    const int p = e / N, n = e % N;
    a.h_last[(st_base + p) * N + n] = st[p * (N + 1) + n];
  }
}

}  // namespace

extern "C" {

// The scan over S rows in chunks of Q (S a multiple of Q, Q <= 256; hp a
// multiple of 16, N of 8, nh of G). h0 may be null (zeros). S == 0 copies
// h0 into h_last. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take.
int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
             const void* C, const void* h0, void* y, void* h_last, int b,
             int S, int nh, int hp, int G, int N, int Q, void* stream) {
  if (b < 0 || S < 0 || hp <= 0 || hp % kPT || N <= 0 || N % 8 || G <= 0 ||
      nh % G || Q < 1 || Q > kMaxQ || S % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || nh == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_bytes(Q, N);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = static_cast<const __nv_bfloat16*>(B);
  a.C = static_cast<const __nv_bfloat16*>(C);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.h_last = static_cast<float*>(h_last);
  a.S = S;
  a.nh = nh;
  a.hp = hp;
  a.G = G;
  a.N = N;
  a.Q = Q;
  ssd_kernel<<<(unsigned)(b * nh * (hp / kPT)), kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
