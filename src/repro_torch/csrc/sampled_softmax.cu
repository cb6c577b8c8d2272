// Fused sampled-softmax loss for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sampled_softmax.py
// (_loss_kernel, driven by sampled_softmax_loss): for T rows of
// activations x, the true-class rows w_true (T, d) and n sampled rows
// w_samp (n, d), both gathered from the vocab table by the gather kernel
// beforehand, the mean over T of lse - lt, where lt = softcap(x . w_true)
// and lse is the log-sum-exp of lt and softcap(x . w_samp^T), the sampled
// logits masked to -1e30 where a sampled id equals the row's label (an
// accidental hit). Logits are fp32 (bf16 products are exact in fp32).
//
// What bounds it on this card: the (T x d) @ (d x n) product, 2 T n d
// operations at the bf16 tensor-core rate (275 GFLOP at glm4_9b's head,
// T = 4096, n = 8192, d = 4096: 0.278 ms at 989 TFLOP/s); the T x n
// logits never leave the chip, as on the TPU they never leave VMEM.
//
// Design, three launches on the caller's stream:
//  1. sampled_lse_kernel, a GEMM whose epilogue reduces its columns to an
//     online (max, sum of exp):
//     * a block of two warpgroups owns 128 rows (64 each) and one of
//       `nsplit` ranges of the sampled columns, walked in 256-column
//       tiles. Row tiles are the grid's fast axis, so the blocks resident
//       together share a range and walk its tiles of w_samp in step (x and
//       w_samp exceed the L2 at glm4's head; each w tile comes from HBM
//       about once);
//     * one thread of warpgroup 0 loads, with TMA, a 128 x 64 box of x and
//       a 256 x 64 box of w_samp for each 64-value step of d into a ring
//       of four 48 KB stages (128B-swizzled), completing on the stage's
//       mbarrier; every thread releases a stage once its products are
//       done. In step s the loader issues step s + 3 into the stage of
//       step s - 1, so three steps of loads are in flight. The ring runs
//       on across column tiles, so the next tile's first loads are in
//       flight during a tile's epilogue. TMA fills rows past T and n with
//       zeros. The loader's code is one straight-line load behind one
//       wait: an opportunistic loop (try the next stage, break if busy)
//       on that divergent path made ptxas serialize the wgmma pipeline
//       (C7518), and the GEMM launch ran at 423 TFLOP/s instead of 773
//       (chip_smoke.py phase 2e, one H100 80GB HBM3 at 700 W);
//     * a warpgroup's 64 x 256 logits are four wgmma m64n256k16 per step
//       (bf16 from shared memory, fp32 sums in 128 registers a thread);
//       a step's products stay in flight while the next step's stage is
//       awaited;
//     * per tile: the softcap (its `if` outside the loops), base 2 (log2 e
//       folded into the scale), the mask of accidental hits (the tile's
//       ids staged once in shared memory) and of columns past n, then each
//       thread's running (max, sum of ex2) over its own 64 columns of its
//       two rows. At the end the four threads of a row merge theirs in a
//       fixed shuffle order and write one (m, l) partial per (row, range),
//       m in natural units.
//  2. row_loss_kernel: one warp per row computes lt (an fp32 dot with a
//     fixed lane order), merges the row's partials in range order with lt
//     into lse, and writes lse - lt.
//  3. mean_kernel: one block sums the T row losses in a fixed tree order
//     and divides by T.
// No atomics, every sum in one fixed order, and the column split a pure
// function of (T, n, the SM count) (kernels/sampled_softmax.plan): two
// launches on the same inputs give the same bits. The TPU kernel's
// cross-block sum becomes launches 2-3.

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, wgmma descriptors and fences, ex2

namespace {

constexpr int BM = 128;                   // rows per block, 64 per warpgroup
constexpr int BN = 256;                   // sampled columns per tile
constexpr int BK = 64;                    // d values per step (128 bytes)
constexpr int STAGES = 4;                 // ring depth
constexpr int AHEAD = STAGES - 1;         // steps loaded ahead of use
constexpr int THREADS = 256;              // two warpgroups
constexpr int X_BYTES = BM * BK * 2;      // the x box of a stage
constexpr int W_BYTES = BN * BK * 2;      // the w_samp box of a stage
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
constexpr int WG_ROWS_BYTES = 64 * 128;   // a warpgroup's 64 rows of x
// shared memory, from a 1024-byte aligned base (the 128B swizzle repeats
// every 8 rows of 128 bytes): the stages, the full and empty barriers,
// then each warpgroup's copy of the tile's sampled ids
constexpr int SM_BAR = STAGES * STAGE_BYTES;
constexpr int SM_IDS = SM_BAR + 16 * STAGES;
constexpr int SM_BYTES = SM_IDS + 2 * BN * 4 + 1024;
constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One box of a 2-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

#define A4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define A16(d, i) A4(d, i), A4(d, i + 4), A4(d, i + 8), A4(d, i + 12)
#define ACC128(d)                                                        \
  A16(d, 0), A16(d, 16), A16(d, 32), A16(d, 48), A16(d, 64), A16(d, 80), \
      A16(d, 96), A16(d, 112)

#define ACC128_STR                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, " \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (64 x 256, fp32) = or += a (64 x 16) * b (16 x 256), both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ACC128_STR
      ", %128, %129, p, 1, 1, 0, 0;\n\t}"
      : ACC128(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef A4
#undef A16
#undef ACC128
#undef ACC128_STR

// Keeps the compiler from moving an accumulator's reads or writes across
// a wgmma wait or fence.
__device__ __forceinline__ void pin(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of m64n256k16 (thread = 128-thread warpgroup index,
// w = thread / 32, lane = 4 g + t): element i sits at row 16 w + g (+ 8
// when bit 1 of i is set) and column 8 (i / 4) + 2 t + (i & 1).
__global__ void __launch_bounds__(THREADS, 1)
sampled_lse_kernel(__grid_constant__ const CUtensorMap xmap,
                   __grid_constant__ const CUtensorMap wmap,
                   const int* __restrict__ labels,
                   const int* __restrict__ sids, float* __restrict__ m_part,
                   float* __restrict__ l_part, int T, int d, int n, int per,
                   int nsplit, float cap) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + SM_BAR;          // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * STAGES;    // empty[s] = empty0 + 8 s

  const int r0 = blockIdx.x * BM, split = blockIdx.y;
  const int tile_lo = split * per;
  const int tiles = min((n + BN - 1) / BN, tile_lo + per) - tile_lo;
  const int ksteps = d / BK, total = tiles * ksteps;

  // Step q's loads go into stage q % STAGES once both warpgroups have
  // released step q - STAGES.
  const bool loader = threadIdx.x == 0;
  auto load = [&](int q) {
    const int s = q % STAGES;
    if (q >= STAGES) mbar_wait(empty0 + 8 * s, ((q / STAGES) - 1) & 1);
    const uint32_t st = base + s * STAGE_BYTES, full = full0 + 8 * s;
    const int k0 = (q % ksteps) * BK, c0 = (tile_lo + q / ksteps) * BN;
    mbar_expect_tx(full, STAGE_BYTES);
    tma_load(st, &xmap, full, k0, r0);
    tma_load(st + X_BYTES, &wmap, full, k0, c0);
  };
  if (loader) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int q = 0; q < min(AHEAD, total); ++q) load(q);
  }
  __syncthreads();

  // warpgroup wg owns rows r0 + 64 wg .. r0 + 64 wg + 63 (broadcast from
  // lane 0, so the compiler knows it is the same across the warp)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128, lane = tid & 31, t = lane & 3;
  const int row = r0 + 64 * wg + 16 * (tid >> 5) + (lane >> 2);  // and + 8
  const int lab[2] = {row < T ? labels[row] : -1,
                      row + 8 < T ? labels[row + 8] : -1};
  int* ids = reinterpret_cast<int*>(smem_raw + (base - raw) + SM_IDS) +
             BN * wg;
  const float cap2 = cap * LOG2E, inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  const float neg2 = NEG * LOG2E;                 // -1e30, base 2
  const uint32_t x_wg = wg * WG_ROWS_BYTES;
  auto release = [&](int step) { mbar_arrive(empty0 + 8 * (step % STAGES)); };

  float acc[128];
  float m[2] = {neg2, neg2}, l[2] = {0.f, 0.f};
  int step = 0;
  for (int j = 0; j < tiles; ++j) {
    const int col0 = (tile_lo + j) * BN;
    // the tile's ids, fetched now and staged after its products
    const int id_lo = col0 + tid < n ? sids[col0 + tid] : 0;
    const int id_hi = col0 + tid + 128 < n ? sids[col0 + tid + 128] : 0;
    for (int k = 0; k < ksteps; ++k, ++step) {
      const int s = step % STAGES;
      const uint32_t st = base + s * STAGE_BYTES;
      mbar_wait(full0 + 8 * s, (step / STAGES) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(acc, sdesc(st + x_wg + 32 * kk, 16, 1024),
                 sdesc(st + X_BYTES + 32 * kk, 16, 1024), k > 0 || kk > 0);
      wg_commit();
      wg_wait<1>();
      if (k > 0) release(step - 1);
      // into the stage of step - 1: waits for the other warpgroup's release
      if (loader && step + AHEAD < total) load(step + AHEAD);
    }
    wg_wait<0>();
    pin(acc);
    release(step - 1);

    wg_bar_sync(1 + wg);          // the previous tile's ids are read
    ids[tid] = id_lo;
    ids[tid + 128] = id_hi;
    wg_bar_sync(1 + wg);
    if (cap > 0.f) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = cap2 * tanhf(acc[i] * inv_cap);
    } else {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] *= LOG2E;
    }
    // element i (column c(i) = 8 (i / 4) + (i & 1) past col0 + 2 t) is past
    // n when c(i) >= lim
    const int lim = n - col0 - 2 * t;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int c8 = 0; c8 < 32; ++c8) {
      const int2 id = *reinterpret_cast<const int2*>(ids + 8 * c8 + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& a0 = acc[4 * c8 + 2 * r];
        float& a1 = acc[4 * c8 + 2 * r + 1];
        a0 = (id.x == lab[r] || 8 * c8 >= lim) ? neg2 : a0;
        a1 = (id.y == lab[r] || 8 * c8 + 1 >= lim) ? neg2 : a1;
        mx[r] = fmaxf(mx[r], fmaxf(a0, a1));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] *= ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 128; ++i)
      l[(i >> 1) & 1] += ex2(acc[i] - m[(i >> 1) & 1]);
    pin(acc);
  }

  // merge the quad's four partials per row in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mm = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 2));
    float ll = l[r] * ex2(m[r] - mm);
    ll += __shfl_xor_sync(0xffffffffu, ll, 1);
    ll += __shfl_xor_sync(0xffffffffu, ll, 2);
    if (t == 0 && row + 8 * r < T) {
      m_part[(size_t)(row + 8 * r) * nsplit + split] = mm * LN2;
      l_part[(size_t)(row + 8 * r) * nsplit + split] = ll;
    }
  }
}

__device__ __forceinline__ float softcap(float z, float cap) {
  return cap > 0.f ? cap * tanhf(z / cap) : z;
}

__global__ void row_loss_kernel(const __nv_bfloat16* __restrict__ x,
                                const __nv_bfloat16* __restrict__ wt,
                                const float* __restrict__ m_part,
                                const float* __restrict__ l_part,
                                float* __restrict__ row_loss, int T, int d,
                                int nsplit, float cap) {
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  const __nv_bfloat16* xr = x + (size_t)row * d;
  const __nv_bfloat16* wr = wt + (size_t)row * d;
  float acc = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
    const uint4 wv = *reinterpret_cast<const uint4*>(wr + c);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&wv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(xp[i]);
      const float2 b = __bfloat1622float2(wp[i]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const float lt = softcap(acc, cap);
  const float* mp = m_part + (size_t)row * nsplit;
  const float* lp = l_part + (size_t)row * nsplit;
  float mx = lt;
  for (int j = 0; j < nsplit; ++j) mx = fmaxf(mx, mp[j]);
  float se = expf(lt - mx);
  for (int j = 0; j < nsplit; ++j) se += lp[j] * expf(mp[j] - mx);
  if (lane == 0) row_loss[row] = mx + logf(se) - lt;
}

__global__ void mean_kernel(const float* __restrict__ row_loss,
                            float* __restrict__ out, int T) {
  __shared__ float red[1024];
  float acc = 0.f;
  for (int i = threadIdx.x; i < T; i += 1024) acc += row_loss[i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = 512; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = red[0] / static_cast<float>(T);
}

// A (rows, d) bf16 row-major tensor as a 2-D map of 64-value x `box_rows`
// boxes, 128B-swizzled; rows past `rows` read as zeros.
bool encode_rows(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows,
                 int d, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// x (T, d), w_true (T, d), w_samp (n, d) bf16 contiguous with d a multiple
// of 64, x and w_samp 16-byte aligned, T and n >= 1; labels (T,), sids (n,)
// int32; scratch m_part, l_part (T, nsplit) and row_loss (T,) fp32 -> out
// (1,) fp32, the mean loss. Each of the nsplit column ranges holds `per`
// 256-column tiles (the last one fewer). cap <= 0 means no softcap.
// Returns -1 when the tensor maps cannot be built, else
// cudaGetLastError() after the last launch.
int sampled_softmax_loss(const void* x, const void* w_true,
                         const void* labels, const void* w_samp,
                         const void* sids, void* m_part, void* l_part,
                         void* row_loss, void* out, int T, int d, int n,
                         int per, int nsplit, float cap, void* stream) {
  EncodeTiled fn = encode_tiled();
  CUtensorMap xm, wm;
  if (fn == nullptr || !encode_rows(fn, &xm, x, T, d, BM) ||
      !encode_rows(fn, &wm, w_samp, n, d, BN))
    return -1;
  cudaError_t e = cudaFuncSetAttribute(
      sampled_lse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((T + BM - 1) / BM, nsplit);
  sampled_lse_kernel<<<grid, THREADS, SM_BYTES, st>>>(
      xm, wm, static_cast<const int*>(labels), static_cast<const int*>(sids),
      static_cast<float*>(m_part), static_cast<float*>(l_part), T, d, n, per,
      nsplit, cap);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  row_loss_kernel<<<(T + 7) / 8, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w_true),
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<float*>(row_loss), T, d, nsplit, cap);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  mean_kernel<<<1, 1024, 0, st>>>(static_cast<const float*>(row_loss),
                                  static_cast<float*>(out), T);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
