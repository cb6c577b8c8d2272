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
// flops at the bf16 tensor-core rate; the T x n logits never leave the
// chip, as on the TPU they never leave VMEM.
//
// What this design does about it (first, simple version), in three
// launches on the caller's stream:
//  1. sampled_lse_kernel: a block of 4 warps owns 64 rows and one of
//     `nsplit` ranges of the sampled columns, walked in 64-column tiles.
//     Each tile's 64 x 64 logits are a k-loop over d in 64-wide chunks of
//     x and w_samp staged in shared memory, multiplied on the tensor cores
//     (mma.sync m16n8k16, bf16 in, fp32 sum); then softcap, the hit mask
//     and an online (max, sum of exp) per thread. The four threads of a
//     row combine theirs in a fixed order and write one partial (m, l)
//     per (row, column range). Splitting the columns keeps the card full
//     when T / 64 blocks alone would not (T = 4096 gives 64 row tiles for
//     132 SMs).
//  2. row_loss_kernel: one warp per row computes lt (an fp32 dot with a
//     fixed lane order), merges the row's partials in column-range order
//     with lt into lse, and writes lse - lt.
//  3. mean_kernel: one block sums the T row losses in a fixed tree order
//     and divides by T.
// No atomics anywhere: two launches on the same inputs give the same
// bits. The TPU kernel's cross-block sum becomes passes 2-3. Not yet used:
// wgmma, TMA, keeping x resident across column tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;          // rows per block, 16 per warp
constexpr int BN = 64;          // sampled columns per tile
constexpr int KC = 64;          // d values per shared-memory chunk
constexpr int STR = KC + 8;     // padded shared-memory row, values
constexpr int THREADS = 128;
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float softcap(float z, float cap) {
  return cap > 0.f ? cap * tanhf(z / cap) : z;
}

// Fragment layout as in flash_attention.cu: lane = 4 g + t; accumulator
// rows g and g + 8, columns 2t and 2t + 1 of each 8-column tile.
__global__ void __launch_bounds__(THREADS)
sampled_lse_kernel(const __nv_bfloat16* __restrict__ x,
                   const int* __restrict__ labels,
                   const __nv_bfloat16* __restrict__ ws,
                   const int* __restrict__ sids, float* __restrict__ m_part,
                   float* __restrict__ l_part, int T, int d, int n,
                   int tiles_per_split, int nsplit, float cap) {
  __shared__ __align__(16) __nv_bfloat16 xs[BT * STR];
  __shared__ __align__(16) __nv_bfloat16 wsh[BN * STR];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BT, split = blockIdx.y;
  const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  const int lab[2] = {rows[0] < T ? labels[rows[0]] : -1,
                      rows[1] < T ? labels[rows[1]] : -1};
  const int n_tiles = (n + BN - 1) / BN;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_split);
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int nt = tile_lo; nt < tile_hi; ++nt) {
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int k0 = 0; k0 < d; k0 += KC) {
      __syncthreads();
      for (int i = threadIdx.x; i < BT * (KC / 8); i += THREADS) {
        const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
        const int gr = r0 + r, gn = nt * BN + r;
        uint4 xv = make_uint4(0, 0, 0, 0), wv = make_uint4(0, 0, 0, 0);
        if (gr < T)
          xv = *reinterpret_cast<const uint4*>(x + (size_t)gr * d + k0 + c);
        if (gn < n)
          wv = *reinterpret_cast<const uint4*>(ws + (size_t)gn * d + k0 + c);
        *reinterpret_cast<uint4*>(xs + r * STR + c) = xv;
        *reinterpret_cast<uint4*>(wsh + r * STR + c) = wv;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        const __nv_bfloat16* xr = xs + (warp * 16 + g) * STR + kk + 2 * t;
        const uint32_t a[4] = {ld32(xr), ld32(xr + 8 * STR), ld32(xr + 8),
                               ld32(xr + 8 * STR + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* wr = wsh + (j * 8 + g) * STR + kk + 2 * t;
          mma_bf16(s[j], a, ld32(wr), ld32(wr + 8));
        }
      }
    }
    // softcap, then the hit mask (and columns past n), then the online
    // (max, sum of exp) of this thread's 16 values per row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float z[16];
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * BN + j * 8 + 2 * t + e;
          float v = softcap(s[j][2 * r + e], cap);
          if (col >= n || sids[col] == lab[r]) v = NEG;
          z[2 * j + e] = v;
          mx = fmaxf(mx, v);
        }
      }
      float sum = l[r] * expf(m[r] - mx);
#pragma unroll
      for (int i = 0; i < 16; ++i) sum += expf(z[i] - mx);
      m[r] = mx;
      l[r] = sum;
    }
  }
  // merge the quad's four partials per row in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mm = m[r];
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 1));
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 2));
    float ll = l[r] * expf(m[r] - mm);
    ll += __shfl_xor_sync(0xffffffffu, ll, 1);
    ll += __shfl_xor_sync(0xffffffffu, ll, 2);
    if (t == 0 && rows[r] < T) {
      m_part[(size_t)rows[r] * nsplit + split] = mm;
      l_part[(size_t)rows[r] * nsplit + split] = ll;
    }
  }
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

}  // namespace

extern "C" {

// x (T, d), w_true (T, d), w_samp (n, d) bf16 contiguous with d a multiple
// of 64; labels (T,), sids (n,) int32; scratch m_part, l_part (T, nsplit)
// and row_loss (T,) fp32 -> out (1,) fp32, the mean loss. Each of the
// nsplit column ranges holds tiles_per_split 64-column tiles. cap <= 0
// means no softcap. Returns cudaGetLastError() after the last launch.
int sampled_softmax_loss(const void* x, const void* w_true,
                         const void* labels, const void* w_samp,
                         const void* sids, void* m_part, void* l_part,
                         void* row_loss, void* out, int T, int d, int n,
                         int tiles_per_split, int nsplit, float cap,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  dim3 grid((T + BT - 1) / BT, nsplit);
  sampled_lse_kernel<<<grid, THREADS, 0, st>>>(
      xb, static_cast<const int*>(labels),
      static_cast<const __nv_bfloat16*>(w_samp),
      static_cast<const int*>(sids), static_cast<float*>(m_part),
      static_cast<float*>(l_part), T, d, n, tiles_per_split, nsplit, cap);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  row_loss_kernel<<<(T + 7) / 8, 256, 0, st>>>(
      xb, static_cast<const __nv_bfloat16*>(w_true),
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<float*>(row_loss), T, d, nsplit, cap);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  mean_kernel<<<1, 1024, 0, st>>>(static_cast<const float*>(row_loss),
                                  static_cast<float*>(out), T);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
