// Paged attention for Hopper (sm_90a): one templated kernel behind the
// decode, chunked-prefill and packed (ragged) prefill entry points of
// paged_attention.cu and ragged_paged_attention.cu.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_decode             <- paged_attention                (_decode_kernel)
//   paged_prefill            <- paged_prefill_attention        (_chunk_kernel)
//   ragged_paged_prefill     <- ragged_paged_prefill_attention (_ragged_kernel)
// A row's bits do not depend on the entry point: a 1-row chunk reproduces
// a decode step, and each packed sequence's rows reproduce an unpacked
// chunk launch (see "Bit for bit" below).
//
// Semantics (same as the TPU kernels): q bf16 with H heads of hd values
// per row; page pools (num_blocks, block_size, K, hd) of bf16, int8 or
// fp8 e4m3; block tables (n_seqs, nb) int32; ctx (n_seqs,) int32 visible
// tokens including the chunk. A sequence's chunk row i sits at absolute
// position ctx - q_len + i and attends causally to keys [0, position]
// (and only the last `window` of them with a sliding window). GQA is
// g-major: q head h reads kv head h % K. Chunk rows past q_len and
// sequences with ctx == 0 produce exact zeros.
//   decode: q (B, H, hd); sequence b owns row b.
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
// What bounds it on this card. Decode reads every live key and value row
// once and does 4 flops per KV element and query head: at glm4's G = 16
// query heads per kv head that is 32 flops per byte of a bf16 pool, far
// below the ~295 at which the tensor cores become the limit, so decode is
// bound by bytes (3.35 TB/s). A prefill chunk of a few hundred rows
// reuses each key for thousands of query rows and is bound by operations
// (989 TFLOP/s of bf16 tensor cores).
//
// What this design does about each:
//  * both products run on the tensor cores: mma.sync m16n8k16, bf16 in,
//    fp32 sums (mma.cuh), one form for every mode. A warp owns 16 query
//    rows (the G heads of a kv head are g-major; decode pads G to 16, and
//    padding rows are masked and never stored). S = Q K^T is hd/16
//    k-steps with Q and K fragments read by ldmatrix; P enters P V as the
//    A operand straight from the S accumulators, as two bf16 parts (hi =
//    bf16(p), lo = bf16(p - hi): p to about 16 bits for 50% more products;
//    with one bf16 rounding, card and CPU greedy tokens parted on the smoke
//    model at a top-2 margin above 1e-2), and V's fragments come through
//    ldmatrix.trans;
//  * keys are walked in steps of kStep = 64 at absolute positions
//    [64 j, 64 (j + 1)), each row gathered through the block table by
//    position (page bt[pos / bs], row pos % bs), so the step does not
//    depend on block_size. A ring of kStages steps in shared memory is
//    filled with 16-byte cp.async copies several steps ahead of the one
//    computed, so decode streams instead of paying a page's latency per
//    step. Rows are padded by 16 bytes (no ldmatrix bank conflicts).
//    Quantized pools land as raw bytes and are dequantized once per step
//    into a bf16 tile;
//  * the online softmax runs in base 2 (exp2f) and keeps its row max and
//    sum in registers: the max over a quad of lanes by two fixed shuffles,
//    each lane's share of the sum in a fixed order, combined at the end of
//    a segment by two fixed shuffles;
//  * parallelism for decode: keys are cut into segments of kSeg = 256 at
//    absolute positions. Decode runs one block per (sequence, kv head,
//    segment), writes each segment's partial state (m, l, unnormalized
//    acc) to a scratch tensor, and a second kernel merges the partials in
//    segment order (at B = 8, K = 2 and 2048 tokens: 128 blocks instead
//    of 16). Chunk and packed tiles of 64 rows (four warps sharing each
//    loaded step: the GQA and chunk reuse) merge segment by segment in
//    registers with the same merge function;
//  * dead steps are skipped: past ctx, before the window, and past the
//    last row position of a tile (per block) or of a warp's 16 rows (per
//    warp);
//  * the partials of pool-sharded serving (decode and chunk; the TPU
//    kernels' block_mask and return_lse): a zero block_mask entry's rows
//    get the ring's zero fill, never a load, and a bit per key per ring
//    stage (written with the stage's loads, read by its compute) masks
//    their scores. With lse, the finalize writes acc / l in fp32 and lse
//    = m ln 2 + log(l) (-1e30 for a row that attended nothing): the same
//    arithmetic, so a full mask's o rounds to the plain bytes. All of it
//    sits behind a template flag (PART): the plain launches run an
//    instantiation without it (behind a runtime test instead, decode and
//    chunk ran 2-5% slower on the H100: tools/paged_ab.py).
//
// Bit for bit: every row is computed by the same sequence of operations
// whatever the entry point, C, B, S, row tile or grid. Each segment's
// partial starts from the empty state and runs the same steps (the
// segment size is one constant, not a function of the launch); the
// partials merge in segment order through merge_stats/merge_acc, where
// an empty partial leaves the running state unchanged. A step or segment
// that is fully masked for a row leaves it as computing it would: the
// max is unchanged, the correction is exactly 1, P is zero and the
// product adds only zeros (chip_smoke's probe: an mma.sync with zero A
// rows returns every non-zero C value bit for bit and turns -0.0 into
// +0.0, which no accumulator here holds: they start at +0.0). Scale,
// softcap, exponentials and merges are explicitly rounded operations (no
// contraction left to the compiler).
// No sum uses atomics, so two launches give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace paged {

constexpr int kThreads = 128;        // four warps
constexpr int kMaxBs = 32;           // largest block_size the kernel takes
constexpr int kStep = 64;            // keys per online-softmax step
constexpr int kSeg = 256;            // keys per segment (partial state)
constexpr int kStepsPerSeg = kSeg / kStep;
constexpr int kStages = 4;           // steps in the shared-memory ring
constexpr int kDecodeRows = 16;      // row tile of a decode block
constexpr int kChunkRows = 64;       // row tile of a chunk / packed block
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;  // scores run in base 2
constexpr float kLn2 = 0.6931471805599453f;

enum Mode : int { kChunk = 0, kRagged = 1, kRaggedWrite = 2, kDecode = 3 };

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
  const int* q_lens;                 // kChunk; null: one row per sequence
  const int* starts;                 // kRagged*
  const int* ends;
  const int* block_mask;             // kChunk/kDecode: (n_seqs, nb) or null
  __nv_bfloat16* out;                // null when lse is given
  float* out32;                      // partials: fp32 o, with lse
  float* lse;                        // partials: (rows, H) fp32, or null
  float* part;                       // kDecode: the segments' partials
  int C, H, K, bs, nb, n_tiles, nseg;
  float scale, cap;
  int window;
};

// Floats of one decode partial: 16 rows of hd accumulators, then 16 row
// maxima and 16 row sums.
__host__ __device__ constexpr int part_floats(int hd) {
  return kDecodeRows * (hd + 2);
}

// The two narrow pool elements in the low 16 bits of `w` as floats:
// exact.
template <typename T>
struct Narrow;

template <>
struct Narrow<int8_t> {
  __device__ __forceinline__ static float2 to_float2(uint32_t w) {
    return make_float2(static_cast<float>(static_cast<int8_t>(w & 0xffu)),
                       static_cast<float>(static_cast<int8_t>(w >> 8)));
  }
};

template <>
struct Narrow<__nv_fp8_e4m3> {
  __device__ __forceinline__ static float2 to_float2(uint32_t w) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3);
    return __half22float2(__half2(h));
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
      const float2 x = Narrow<T>::to_float2(w[i] >> (16 * h));
      d[2 * i + h] = pack_bf16(__fmul_rn(x.x, s), __fmul_rn(x.y, s));
    }
  }
}

// Folds a partial softmax state (mp, lp, acc_p) into a running one
// (m, l, acc); maxima are in base 2. Returns 0 when the partial is empty
// (lp == 0: the running state stays exactly as it was), 1 when the
// running state is empty (it becomes the partial), 2 when the two combine
// with factors ca and cp.
// Every merge of every mode goes through this and merge_acc.
__device__ __forceinline__ int merge_stats(float& m, float& l, float mp,
                                           float lp, float& ca, float& cp) {
  if (lp == 0.f) return 0;
  if (l == 0.f) {
    m = mp;
    l = lp;
    return 1;
  }
  const float mn = fmaxf(m, mp);
  ca = exp2f(__fsub_rn(m, mn));
  cp = exp2f(__fsub_rn(mp, mn));
  m = mn;
  l = __fadd_rn(__fmul_rn(l, ca), __fmul_rn(lp, cp));
  return 2;
}

__device__ __forceinline__ float merge_acc(int how, float acc, float acc_p,
                                           float ca, float cp) {
  if (how == 0) return acc;
  if (how == 1) return acc_p;
  return __fadd_rn(__fmul_rn(acc, ca), __fmul_rn(acc_p, cp));
}

// The finalize of every mode: acc / max(l, 1e-37), rounded to bf16 (or
// kept in fp32 for a partial).
__device__ __forceinline__ float finish(float acc, float l) {
  return __fdiv_rn(acc, fmaxf(l, 1e-37f));
}

// A partial's natural log-sum-exp from the base-2 max m and the sum l:
// m ln 2 + log(l); -1e30 for a row that attended nothing (l == 0).
__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.f ? __fadd_rn(__fmul_rn(m, kLn2), logf(l)) : kNegInf;
}

// One sequence's rows as the kernel sees them.
struct Seq {
  int qlen, row0, rows_total, qstart, kend;
};

template <int MODE>
__device__ __forceinline__ Seq seq_of(const Args& a, int b) {
  Seq s;
  const int ctx = a.ctx_lens[b];
  const int G = a.H / a.K;
  if constexpr (MODE == kChunk || MODE == kDecode) {
    s.qlen = a.q_lens ? a.q_lens[b] : 1;
    s.row0 = b * a.C;
    s.rows_total = a.C * G;          // padding rows come out as zeros
  } else {
    s.row0 = a.starts[b];
    s.qlen = max(a.ends[b] - s.row0, 0);
    s.rows_total = s.qlen * G;
  }
  s.qstart = ctx - s.qlen;           // absolute position of chunk row 0
  s.kend = min(ctx, a.nb * a.bs);    // keys past the table are never seen
  return s;
}

// The keys [klo, khi) that rows [r_lo, r_hi) of a sequence can see: the
// TPU kernels' liveness tests (past ctx, before the window) plus the
// causal cut at the last row's position. Empty (0, 0) for padding rows.
__device__ __forceinline__ void key_range(const Seq& s, int G, int window,
                                          int r_lo, int r_hi, int& klo,
                                          int& khi) {
  klo = khi = 0;
  r_hi = min(r_hi, s.rows_total);
  if (r_lo >= r_hi) return;
  const int c_lo = r_lo / G, c_last = min((r_hi - 1) / G, s.qlen - 1);
  if (c_lo > c_last) return;
  const int hi = min(s.kend, s.qstart + c_last + 1);
  const int lo = window > 0 ? max(0, s.qstart + c_lo - window + 1) : 0;
  if (lo < hi) {
    klo = lo;
    khi = hi;
  }
}

template <int HD, int ROWS, typename T>
constexpr int smem_bytes() {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int QST = HD + 8;                     // padded bf16 row
  constexpr int RSTB = HD * (int)sizeof(T) + 16;  // padded pool row, bytes
  constexpr int STAGE = 2 * kStep * RSTB + (QUANT ? 2 * kStep * 4 : 0);
  return ROWS * QST * 2 + kStages * STAGE +
         (QUANT ? 2 * kStep * QST * 2 : 0) + kStages * kStep * 4 +
         kStages * 8;
}

// One block: (sequence, kv head, tile of ROWS query rows) and, for
// kDecode, one segment of keys. PART: the partials' launch (a block mask
// or an lse); without it their code is compiled out.
template <int HD, int ROWS, typename T, int MODE, bool PART>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args a) {
  constexpr bool SPLIT = MODE == kDecode;
  const int* const block_mask = PART ? a.block_mask : nullptr;
  float* const lse_out = PART ? a.lse : nullptr;
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int QST = HD + 8;                     // padded bf16 row
  constexpr int RSTB = HD * (int)sizeof(T) + 16;  // padded pool row, bytes
  constexpr int VEC = HD * (int)sizeof(T) / 16;   // 16-byte vectors a row
  constexpr int STAGE = 2 * kStep * RSTB + (QUANT ? 2 * kStep * 4 : 0);
  constexpr int NT = HD / 8;                      // 8-column output tiles
  constexpr int KS = HD / 16;                     // k-steps of q k^T
  constexpr int WARPS = ROWS / 16;                // warps that own rows

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + ROWS * QST * 2;
  __nv_bfloat16* kb_s =
      reinterpret_cast<__nv_bfloat16*>(ring + kStages * STAGE);
  __nv_bfloat16* vb_s = kb_s + kStep * QST;
  int* roff_s = reinterpret_cast<int*>(ring + kStages * STAGE +
                                       (QUANT ? 2 * kStep * QST * 2 : 0));
  // with a block mask: per ring stage, bit t of the step's key t is set
  // where the tile reads that key (two words of 32 keys)
  uint32_t* live_s = reinterpret_cast<uint32_t*>(roff_s + kStages * kStep);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  int bid = blockIdx.x;
  int seg = 0;
  if constexpr (SPLIT) {
    seg = bid % a.nseg;
    bid /= a.nseg;
  }
  const int tile = bid % a.n_tiles;
  bid /= a.n_tiles;
  const int kh = bid % a.K;
  const int b = bid / a.K;           // the sequence
  const int H = a.H, K = a.K, bs = a.bs, nb = a.nb;
  const int G = H / K;
  const int r0 = tile * ROWS;
  const Seq sq = seq_of<MODE>(a, b);
  if (MODE != kChunk && MODE != kDecode && r0 >= sq.rows_total) return;

  int klo, khi;                      // the tile's live keys
  key_range(sq, G, a.window, r0, r0 + ROWS, klo, khi);
  int jlo = klo / kStep, jhi = (khi + kStep - 1) / kStep;
  if constexpr (SPLIT) {
    jlo = max(jlo, seg * kStepsPerSeg);
    jhi = min(jhi, (seg + 1) * kStepsPerSeg);
    if (jlo >= jhi) return;          // a dead segment: no partial
  }
  const T* k_pages = static_cast<const T*>(a.k_pages);
  const T* v_pages = static_cast<const T*>(a.v_pages);
  const T* k_new = static_cast<const T*>(a.k_new);
  const T* v_new = static_cast<const T*>(a.v_new);

  if constexpr (MODE == kRaggedWrite) {
    // store the chunk rows whose g = 0 query row is in this tile: each
    // chunk row is stored by exactly one tile; nothing reads it back
    const int c_first = (r0 + G - 1) / G;
    const int n_c = max(min(sq.qlen, (r0 + ROWS + G - 1) / G) - c_first, 0);
    for (int i = tid; i < 2 * n_c * VEC; i += kThreads) {
      const int which = i / (n_c * VEC), rem = i % (n_c * VEC);
      const int c = c_first + rem / VEC, c8 = rem % VEC;
      const int pos = sq.qstart + c;
      if (pos < 0) continue;
      const int page = a.block_tables[b * nb + min(pos / bs, nb - 1)];
      const size_t dst = ((size_t)(page * bs + pos % bs) * K + kh) * HD;
      const size_t src = ((size_t)(sq.row0 + c) * K + kh) * HD;
      const T* from = which ? v_new : k_new;
      T* to = static_cast<T*>(which ? a.v_pages : a.k_pages);
      reinterpret_cast<uint4*>(to + dst)[c8] =
          reinterpret_cast<const uint4*>(from + src)[c8];
    }
  }

  // query tile -> shared memory (zeros past the last row)
  for (int i = tid; i < ROWS * (HD / 8); i += kThreads) {
    const int r = i / (HD / 8), c8 = i % (HD / 8), rr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rr < sq.rows_total) {
      const int c = rr / G, g = rr % G;
      val = reinterpret_cast<const uint4*>(
          a.q + ((size_t)(sq.row0 + c) * H + g * K + kh) * HD)[c8];
    }
    *reinterpret_cast<uint4*>(q_s + r * QST + c8 * 8) = val;
  }

  // the pool row (page * bs + pos % bs) of key t of step j, or -1 where
  // the tile sees no key (those ring rows are zero-filled)
  auto row_of = [&](int j, int t) -> int {
    const int p = j * kStep + t;
    if (p < klo || p >= khi) return -1;
    if (block_mask != nullptr && block_mask[b * nb + p / bs] == 0)
      return -1;                     // a masked entry: never read
    return a.block_tables[b * nb + p / bs] * bs + p % bs;
  };
  // step j's keys and values (and scales) -> ring stage, asynchronously
  auto fetch = [&](int j) {
    const int st = (j - jlo) % kStages;
    unsigned char* sb = ring + st * STAGE;
    const int* ro = roff_s + st * kStep;
    if (block_mask != nullptr && tid < kStep) {   // warps 0 and 1
      const uint32_t bits = __ballot_sync(0xffffffffu, ro[tid] >= 0);
      if (lane == 0) live_s[st * 2 + warp] = bits;
    }
#pragma unroll
    for (int k = 0; k < (kStep * VEC + kThreads - 1) / kThreads; ++k) {
      const int i = tid + k * kThreads;
      if (kStep * VEC % kThreads != 0 && i >= kStep * VEC) break;
      const int t = i / VEC, c = i % VEC;
      const int r = ro[t];
      const T* ks = k_pages;
      const T* vs = v_pages;
      size_t off = r >= 0 ? ((size_t)r * K + kh) * HD : 0;
      if constexpr (MODE == kRaggedWrite) {
        const int p = j * kStep + t;   // the chunk's own keys: from k_new
        if (r >= 0 && p >= sq.qstart) {
          off = ((size_t)(sq.row0 + p - sq.qstart) * K + kh) * HD;
          ks = k_new;
          vs = v_new;
        }
      }
      cp_async16(sb + t * RSTB + c * 16,
                 reinterpret_cast<const uint4*>(ks + off) + c, r >= 0);
      cp_async16(sb + kStep * RSTB + t * RSTB + c * 16,
                 reinterpret_cast<const uint4*>(vs + off) + c, r >= 0);
    }
    if constexpr (QUANT) {
      if (tid < 2 * kStep) {
        const int t = tid % kStep, which = tid / kStep, r = ro[t];
        const float* sp = which ? a.v_scale : a.k_scale;
        cp_async4(sb + 2 * kStep * RSTB + (which * kStep + t) * 4,
                  sp + (r >= 0 ? (size_t)r * K + kh : 0), r >= 0);
      }
    }
  };

  if (tid < kStep)
    for (int s = 0; s < kStages && jlo + s < jhi; ++s)
      roff_s[s * kStep + tid] = row_of(jlo + s, tid);
  __syncthreads();                   // q_s and the first row offsets
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (jlo + s < jhi) fetch(jlo + s);
    cp_async_commit();
  }

  // this warp's rows (g8 and g8 + 8 of its 16): their live keys
  // [lo, hi), and the keys the warp as a whole can see
  const int wr0 = r0 + warp * 16;
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = wr0 + g8 + 8 * h, c = rr / G;
    const int qpos = sq.qstart + c;
    const bool ok = warp < WARPS && rr < sq.rows_total && c < sq.qlen;
    hi[h] = ok ? min(qpos + 1, sq.kend) : 0;
    lo[h] = a.window > 0 ? qpos - a.window + 1 : 0;
  }
  int wlo = 0, whi = 0;
  if (warp < WARPS) key_range(sq, G, a.window, wr0, wr0 + 16, wlo, whi);

  // per segment: m, l (this lane's share) and acc; running: the merge
  float m_s[2] = {kNegInf, kNegInf}, l_s[2] = {0.f, 0.f};
  float acc_s[NT][4];
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float acc_r[SPLIT ? 1 : NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_s[n][e] = 0.f;
  if constexpr (!SPLIT) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_r[n][e] = 0.f;
  }

  // l over the quad's lanes, in one fixed order (the same bits on all four)
  auto quad_sum = [&](float x) {
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
  };

  for (int j = jlo; j < jhi; ++j) {
    const int st = (j - jlo) % kStages;
    // row offsets of step j + kStages, read now, stored after the compute
    const int nxt = tid < kStep && j + kStages < jhi
                        ? row_of(j + kStages, tid) : -1;
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // step j landed; step j - 1 consumed
    const __nv_bfloat16* k_t;
    const __nv_bfloat16* v_t;
    if constexpr (QUANT) {
      const unsigned char* sb = ring + st * STAGE;
      const float* scl = reinterpret_cast<const float*>(sb + 2 * kStep * RSTB);
#pragma unroll
      for (int k = 0; k < 2 * kStep * VEC / kThreads; ++k) {
        const int i = tid + k * kThreads;
        const int which = i / (kStep * VEC), rem = i % (kStep * VEC);
        const int t = rem / VEC, c = rem % VEC;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            sb + (which * kStep + t) * RSTB + c * 16);
        dequant16<T>(raw, scl[which * kStep + t],
                     (which ? vb_s : kb_s) + t * QST + c * 16);
      }
      __syncthreads();
      k_t = kb_s;
      v_t = vb_s;
    } else {
      k_t = reinterpret_cast<const __nv_bfloat16*>(ring + st * STAGE);
      v_t = k_t + kStep * QST;
    }
    if (j + kStages - 1 < jhi) fetch(j + kStages - 1);
    cp_async_commit();

    const int k0 = j * kStep;
    // with a block mask, the keys of step j the tile reads
    uint64_t live = 0;
    if (block_mask != nullptr)
      live = live_s[st * 2] | (uint64_t)live_s[st * 2 + 1] << 32;
    if (warp < WARPS && k0 < whi && k0 + kStep > wlo) {
      // S = Q K^T: 16 rows x 64 keys, hd / 16 k-steps
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4];
        ldsm_x4(qa, q_s + (warp * 16 + ri + (mi & 1) * 8) * QST + ks * 16 +
                        (mi >> 1) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, k_t + (np * 16 + ri + (mi >> 1) * 8) * QST + ks * 16 +
                          (mi & 1) * 8);
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      // scale -> softcap -> to base 2 -> mask; the rows' maxima over the
      // quad. The softcap's branch stays outside the loop: inside it the
      // compiler predicates tanhf and the division for every score.
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], a.scale);
      if (a.cap > 0.f) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = __fmul_rn(a.cap, tanhf(__fdiv_rn(s[n][e], a.cap)));
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, kpos = k0 + n * 8 + 2 * t4 + (e & 1);
          s[n][e] = kpos >= lo[h] && kpos < hi[h]
                        ? __fmul_rn(s[n][e], kLog2e) : kNegInf;
        }
      }
      // a block mask's keys: a branch of its own, as the softcap's
      if (block_mask != nullptr) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!(live >> (n * 8 + 2 * t4 + (e & 1)) & 1)) s[n][e] = kNegInf;
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_s[h], mx[h]);
        corr[h] = exp2f(__fsub_rn(m_s[h], m_new));
        m_s[h] = m_new;
      }
      // p and this lane's sums; a masked score is -1e30, so its p is 0
      // whenever the row max is a real score, and the masked-row guard
      // (all masked so far) subtracts 0 instead of -1e30
      float lsum[2] = {0.f, 0.f};
      const float mg[2] = {m_s[0] == kNegInf ? 0.f : m_s[0],
                           m_s[1] == kNegInf ? 0.f : m_s[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = exp2f(__fsub_rn(s[n][e], mg[h]));
          s[n][e] = p;
          lsum[h] = __fadd_rn(lsum[h], p);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l_s[h] = __fmaf_rn(l_s[h], corr[h], lsum[h]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_s[n][e] = __fmul_rn(acc_s[n][e], corr[e >> 1]);
      // acc += P V: P from the S accumulators as two bf16 parts, hi =
      // bf16(p) and lo = bf16(p - hi) (p to about 16 bits: one bf16
      // rounding of p parted card and CPU greedy tokens at a top-2 margin
      // above 1e-2 on the smoke model), V through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* sv = s[2 * kk + (r >> 1)] + 2 * (r & 1);
          ph[r] = pack_bf16(sv[0], sv[1]);
          const float2 hf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ph[r]));
          pl[r] = pack_bf16(__fsub_rn(sv[0], hf.x), __fsub_rn(sv[1], hf.y));
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vb[4];
          ldsm_x4_t(vb, v_t + (kk * 16 + ri + (mi & 1) * 8) * QST + np * 16 +
                            (mi >> 1) * 8);
          mma_bf16(acc_s[2 * np], ph, vb[0], vb[1]);
          mma_bf16(acc_s[2 * np + 1], ph, vb[2], vb[3]);
          mma_bf16(acc_s[2 * np], pl, vb[0], vb[1]);
          mma_bf16(acc_s[2 * np + 1], pl, vb[2], vb[3]);
        }
      }
    }

    if constexpr (!SPLIT) {
      // the end of a segment (or of the tile's keys): merge and restart
      if (warp < WARPS && ((j + 1) % kStepsPerSeg == 0 || j + 1 == jhi)) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ca = 0.f, cp = 0.f;
          const int how =
              merge_stats(m_r[h], l_r[h], m_s[h], quad_sum(l_s[h]), ca, cp);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              acc_r[n][e] = merge_acc(how, acc_r[n][e], acc_s[n][e], ca, cp);
              acc_s[n][e] = 0.f;
            }
          m_s[h] = kNegInf;
          l_s[h] = 0.f;
        }
      }
    }
    if (tid < kStep && j + kStages < jhi) roff_s[st * kStep + tid] = nxt;
  }
  cp_async_wait<0>();

  if constexpr (SPLIT) {
    // this segment's partial -> scratch
    if (warp < WARPS) {
      float* pp = a.part + ((size_t)((b * K + kh) * a.n_tiles + tile) *
                                a.nseg + seg) * part_floats(HD);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g8 + 8 * h;
        const float l = quad_sum(l_s[h]);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float2*>(pp + r * HD + n * 8 + 2 * t4) =
              make_float2(acc_s[n][2 * h], acc_s[n][2 * h + 1]);
        if (t4 == 0) {
          pp[kDecodeRows * HD + r] = m_s[h];
          pp[kDecodeRows * HD + kDecodeRows + r] = l;
        }
      }
    }
  } else {
    // finalize: acc / max(l, 1e-37) -> bf16, back to the q row layout;
    // a partial keeps it in fp32 and writes the row's lse
    if (warp < WARPS) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = wr0 + g8 + 8 * h;
        if (rr >= sq.rows_total) continue;
        const int c = rr / G, g = rr % G;
        const size_t row = (size_t)(sq.row0 + c) * H + g * K + kh;
        if (lse_out != nullptr) {
          float* orow = a.out32 + row * HD + 2 * t4;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            *reinterpret_cast<float2*>(orow + n * 8) =
                make_float2(finish(acc_r[n][2 * h], l_r[h]),
                            finish(acc_r[n][2 * h + 1], l_r[h]));
          if (t4 == 0) lse_out[row] = lse_of(m_r[h], l_r[h]);
          continue;
        }
        __nv_bfloat16* orow = a.out + row * HD + 2 * t4;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(finish(acc_r[n][2 * h], l_r[h]),
                        finish(acc_r[n][2 * h + 1], l_r[h]));
      }
    }
  }
}

// Decode's second pass: one block per (sequence, kv head, row tile, 16
// columns) merges the live segments' partials in segment order and
// finalizes. Eight threads share a row, each holding two of its columns.
template <int HD, bool PART>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const Args a) {
  constexpr int CB = HD / 16;        // column blocks of 16
  int bid = blockIdx.x;
  const int col = (bid % CB) * 16 + (threadIdx.x % 8) * 2;
  bid /= CB;
  const int tile = bid % a.n_tiles;
  const int kh = (bid / a.n_tiles) % a.K;
  const int b = bid / a.n_tiles / a.K;
  const int G = a.H / a.K;
  const Seq sq = seq_of<kDecode>(a, b);
  const int r0 = tile * kDecodeRows;
  const int row = threadIdx.x / 8, rr = r0 + row;
  int klo, khi;
  key_range(sq, G, a.window, r0, r0 + kDecodeRows, klo, khi);
  const int s_lo = klo / kSeg, s_hi = (khi + kSeg - 1) / kSeg;

  float m = kNegInf, l = 0.f;
  float2 acc = make_float2(0.f, 0.f);
  const float* base = a.part + (size_t)((b * a.K + kh) * a.n_tiles + tile) *
                                   a.nseg * part_floats(HD);
  // BATCH segments' partials are loaded at once, then merged in order
  constexpr int BATCH = 8;
  for (int s0 = s_lo; s0 < s_hi; s0 += BATCH) {
    float mp[BATCH], lp[BATCH];
    float2 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (s0 + u >= s_hi) break;
      const float* pp = base + (size_t)(s0 + u) * part_floats(HD);
      mp[u] = pp[kDecodeRows * HD + row];
      lp[u] = pp[kDecodeRows * HD + kDecodeRows + row];
      v[u] = *reinterpret_cast<const float2*>(pp + row * HD + col);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (s0 + u >= s_hi) break;
      float ca = 0.f, cp = 0.f;
      const int how = merge_stats(m, l, mp[u], lp[u], ca, cp);
      acc.x = merge_acc(how, acc.x, v[u].x, ca, cp);
      acc.y = merge_acc(how, acc.y, v[u].y, ca, cp);
    }
  }
  if (rr >= sq.rows_total) return;
  const int c = rr / G, g = rr % G;
  const size_t orow = (size_t)(sq.row0 + c) * a.H + g * a.K + kh;
  if (PART && a.lse != nullptr) {    // a partial: fp32 o and the lse
    *reinterpret_cast<float2*>(a.out32 + orow * HD + col) =
        make_float2(finish(acc.x, l), finish(acc.y, l));
    if (col == 0) a.lse[orow] = lse_of(m, l);
    return;
  }
  *reinterpret_cast<uint32_t*>(a.out + orow * HD + col) =
      pack_bf16(finish(acc.x, l), finish(acc.y, l));
}

// `rows` is the row count one sequence can hold (G for decode, C*G, or
// T*G when packed). The row tile only sets how many rows share a loaded
// step; no row's arithmetic depends on it.
template <typename T, int MODE, int HD, bool PART>
cudaError_t launch_kernel(Args a, int n_seqs, int rows,
                          cudaStream_t stream) {
  constexpr int ROWS = MODE == kDecode ? kDecodeRows : kChunkRows;
  constexpr int SMEM = smem_bytes<HD, ROWS, T>();
  auto kernel = paged_attention_kernel<HD, ROWS, T, MODE, PART>;
  a.n_tiles = (rows + ROWS - 1) / ROWS;
  const long long blocks =
      (long long)n_seqs * a.K * a.n_tiles * (MODE == kDecode ? a.nseg : 1);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  if (blocks > 0)
    kernel<<<(unsigned)blocks, kThreads, SMEM, stream>>>(a);
  if constexpr (MODE == kDecode) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const unsigned merge_blocks = n_seqs * a.K * a.n_tiles * (HD / 16);
    paged_merge_kernel<HD, PART><<<merge_blocks, kThreads, 0, stream>>>(
        a);
  }
  return cudaGetLastError();
}

// The partials' instantiation for a launch with a block mask or an lse
// (decode and chunk only), the plain one otherwise.
template <typename T, int MODE, int HD>
cudaError_t launch_hd(const Args& a, int n_seqs, int rows,
                      cudaStream_t stream) {
  if constexpr (MODE == kChunk || MODE == kDecode) {
    if (a.block_mask != nullptr || a.lse != nullptr)
      return launch_kernel<T, MODE, HD, true>(a, n_seqs, rows, stream);
  }
  return launch_kernel<T, MODE, HD, false>(a, n_seqs, rows, stream);
}

template <typename T, int MODE>
cudaError_t launch_type(const Args& a, int n_seqs, int rows, int hd,
                        cudaStream_t stream) {
  switch (hd) {     // glm4_9b: 128; zamba2_2p7b: 80; whisper: 64; smoke: 16
    case 16:
      return launch_hd<T, MODE, 16>(a, n_seqs, rows, stream);
    case 64:
      return launch_hd<T, MODE, 64>(a, n_seqs, rows, stream);
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
  if ((pool_type != kPoolBf16) != has_scales || a.bs > kMaxBs)
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
