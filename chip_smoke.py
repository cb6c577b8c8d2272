#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

  python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases, each of which raises on failure:
  1. card: name and power limit (nvidia-smi); build the CUDA kernels from
     src/repro_torch/csrc with nvcc, all sources in parallel; print
     ptxas' registers, spills and notes, and fail if it serialized
     sampled_softmax.cu's wgmma pipeline (C7512/C7518/C7520).
  2. kernels vs plain versions on the card, at glm4_9b's widths (H=32,
     K=2, hd=128, 16-token pages), over bf16, int8 and fp8 pools (the
     narrow ones with fp32 per-row scales, dequantized in-tile): each
     output row within 1e-2 relative to its norm, every value within 1e-2
     absolute (1e-2 relative above a magnitude of 1).
     a. decode (8 sequences up to 2048 tokens) and a 256-row prefill
        chunk: a 1-row chunk equals a decode step bit for bit; inactive
        and padding rows are exact zeros; decode and chunk at zamba2's
        shared attention (H = K = 32, hd 80, bf16); window + softcap at hd
        128 and 16; the gather from the 151552 x 4096 embedding table
        and from mamba2_370m's and zamba2_2p7b's tables (bit for bit; at
        glm4's table 1, 8, 256 and 4096 ids, ids 0 and V - 1 and
        out-of-range ids, which count from the end when negative and are
        then clamped, as jnp indexes); its times at 8, 256
        and 4096 ids beside index_select's, by events and from the
        profiler, and the event time of a one-element launch (the floor).
     b. the packed (ragged) kernel: T=512 flat rows, S=4 sequences with
        q_lens [200, 96, 150, 40] at ctx [2048, 96, 700, 1000] (one fresh
        prompt, 26 rows that no sequence owns), without and with the
        fused KV write: a 1-sequence launch equals the chunk kernel and
        each packed sequence equals its unpacked launch, bit for bit; pool
        bytes after the fused write equal the separate scatter; the fused
        output equals the kernel run after that scatter, bit for bit;
        unowned rows are exact zeros.
     c. the SSD scan at mamba2_370m's (nh 32, hp 64, N 128) and
        zamba2_2p7b's (nh 80, hp 64, N 64) widths, 256-row chunks, one and
        two sequences of one and two chunks, plus the smoke widths and a
        grouped case: y rows within 1e-2 of their norm, h_last within
        1e-3 of max(1, |plain|); one launch over 512 rows equals two
        launches of 256 with the state carried, and rows with dt = 0
        leave h_last and the earlier rows' y unchanged, bit for bit, eager
        and under CUDA-graph replay (the replay equal to the eager
        launch); the one-launch graph's edges by type show whether the
        capture kept the programmatic dependent launch. Its two launches
        (C B^T, then the scan) timed by events, by the profiler (their
        sum and each) and as a span on the device.
     d. the flash attention forward at glm4_9b's training shape (B=2,
        S=2048, H=32, K=2, hd=128, causal), with window 512 and cap 50,
        256 rows at q_offset 1792, non-causal 200 rows, hd 16 (the mma
        route), and on the hd-128 route's 128-row and 128-key tile edges
        (Sq 129 and 255, Skv 130 non-causal, 148 rows at q_offset 1900,
        window 100 with cap 50): o rows within 1e-2 of dense_attention's,
        lse within 1e-3 of the plain logsumexp, FlashAttention's dq/dk/dv
        within 1e-2 of each gradient's max against autograd through
        dense_attention, and two launches bit-equal. The hd-128 route's
        time beside scaled_dot_product_attention's (events and profiler,
        TFLOP/s), the hd-16 route's time, and the hd-128 route at one key
        tile per block, non-causal S=2048 and causal S=8192.
     e. the sampled-softmax loss at glm4_9b's 151552 x 4096 bf16 head,
        n = 8192 sampled ids, T = 4096 and 4095, no cap and cap 30; the
        GEMM launch's tile edges there (n = 8000 and 64, T = 100) and
        zamba2_2p7b's 32000 x 2560 head; accidental hits planted: within
        1e-4 relative of the plain loss, two launches bit-equal. Its
        device time by launch (the two gathers, the GEMM launch and its
        TFLOP/s, row loss, mean) and torch.mm's time for the same bf16
        product (gemm_ms, a yardstick the port never calls).
     f. the rest of the dense family's heads at hd 128, bf16 pools:
        gemma2_27b (H=32, K=16) with its local layers' window 4096, cap
        50 and scale 144^-0.5 at contexts to 6144 (and its global layers'
        cap and scale), qwen3_32b (64, 8) and starcoder2_3b (24, 2)
        causal at glm4's lengths: decode (8 sequences), a 256-row chunk
        and the packed kernel (T=512, S=4, fused write) against their
        plain versions, decode == chunk(C=1), packed S=1 == chunk, packed
        == unpacked and fused == scatter bit for bit; the flash forward at
        gemma2's 6144-token prompt (window, cap, scale) and causal S=2048
        at the other two, and at phase 10's static prefill shapes (B=8,
        S=512 for each; B=2, S=6000 for gemma2, a partial last row tile),
        gemma2 also with its global layers' options: o within 1e-2 of
        dense_attention, lse within 1e-3 of the plain one, two launches
        bit-equal; beside SDPA where SDPA computes the same function (no
        softcap: for gemma2 SDPA's causal time is a yardstick); the gather at each member's table (256000 x 4608,
        152064 x 5120, 49152 x 3072). Under "<member>_" keys of each
        kernel's row.
     Times each kernel, its plain version and the one-call library
     equivalent where there is one, with the L2 cache flushed per call.
  3. serving: glm4_9b at full width and depth (40 layers, random weights
     from a seed) through repro_torch.serving.InferenceEngine: 8 requests
     of 512 tokens sharing a 256-token prefix, 32 new tokens each, 256-
     token chunks, bf16 pools. Phases 3-6 run the engine's default on the
     card, its two step shapes as CUDA graphs; phase 3, phase 4's first
     run and every phase 5 run are repeated eager (cuda_graphs=False, the
     same weights and requests) and their greedy tokens must be
     byte-identical. A graph engine captures both shapes before its run
     (engine.capture_graphs, as at a server's start-up; the time is
     printed apart). Each run prints tok/s, TTFT, token gap, the mean
     wall time of decode and chunk steps (each shape's first step left
     out), the body's device span per step by CUDA events around the
     replay (or the eager body), the busy share by those events (their
     sum over the run's wall time; for eager, whose events also span the
     host's launch gaps, the graph run's device time over the eager
     wall), peak memory, the graph pool's memory and the decode step's
     bytes floor (weights and the fp32 head at HBM rate).
  4. packed serving over int8 pools: the same model and weights,
     prefill_pack 4, max_batch 8, a 520-token step budget (512-row chunk
     row), 16 requests at step 0 with prompts of 96-480 tokens (seed 0),
     the first 8 sharing a 128-token prefix, 16 new tokens each: some
     step carries >= 2 chunks, prefix hits, int8 pools. Then four shorter
     runs of the first 8 requests (4 new tokens) cover the other pool and
     pack pairs: (4, bf16), (4, fp8), (1, int8), (1, fp8).
  5. SSM and hybrid serving at full width and depth (random weights from
     seed 0, max_batch 8, a 264-token budget: 256-token chunks, the SSD
     chunk size): mamba2_370m (48 layers) with 8 prompts of 512 tokens
     (32 new tokens each), then 8 of 300-500 tokens (16 new: a quantized
     256-token chunk and a final exempt one); zamba2_2p7b (54 mamba
     layers, the shared attention block every 6) with 8 of 512 tokens (16
     new). The ssd kernel launches once per mamba layer and chunk.
     The chunk graph's edges by type (full, programmatic) are printed.
     Before every serving run each kernel's launch count is zeroed; after
     it the run's kernels must have launched, replay-aware: the counters'
     own launches (a graph's warm-up and capture) plus, per step shape,
     replays x the launches its capture recorded; on graphs each kernel
     must be in a replayed graph. Every kernel variant in the summary
     launched on one of these full-width graph runs.
  6. card vs CPU: the same engine at smoke size on both, same weights and
     requests: glm4 at (prefill_pack, kv_dtype) = (1, bf16), (4, bf16),
     (4, int8) and (1, fp8), mamba2 and zamba2 with quantized chunks (and
     zamba2 preempting): greedy tokens must agree, except after a first
     difference whose top-2 logit margin is below the bf16 tolerance. On
     the card, pack 4 and pack 1 give the same bf16 tokens. gemma2_27b's
     smoke config at packs 1 and 4 (its 16-token window, both softcaps
     and post-block norms through the hd-16 kernels).
  7. training: glm4_9b at full width with 8 of its 40 layers (seeded fp32
     masters, bf16 working params, AdamW with fp32 slots, remat full),
     6 steps of B=2 x S=2048 from ShardedSource(seed=0) through
     launch.train.train: every loss finite, the last below the first,
     every parameter leaf with a finite non-zero gradient on step 1, the
     flash kernel launched 2 x layers x steps times on its hd-128 (wgmma)
     route and never on the hd-16 one, and the gather once per step;
     per-step ms, tokens/s and peak memory (after collecting the earlier
     phases' garbage); then one more step
     under torch.profiler (device time by kernel, busy share).
  8. training card vs CPU at smoke size: the same fp32 masters and three
     batches, 2 microbatches, remat full, SGD: losses within 1e-2, grad
     norms within 1e-2 relative, masters within 1e-2 of the largest
     update.
  9. the sampling surface at glm4_9b's full width and depth (phase 3's
     weights, CUDA graphs; run between phases 4 and 5, while they are on
     the card): a. jax's threefry bits for 64 (seed, rid, counter, tag)
     keys over 151552 words equal on the card and the CPU, the Gumbel
     noise within 2 ulp of max(1, |g|), the first words printed; the
     in-graph draw's device time over (9, 151552) rows (plain, full, an
     argmax). b. a
     greedy + temperature/top-k batch alone (greedy and plain graphs) and
     beside one logprobs request (full graphs): byte-identical tokens;
     eight mixed requests (greedy; t 0.8 top-k 50; top-p 0.9 min-p 0.05;
     repetition/presence/frequency penalties; logprobs 5; a stop sequence
     from the first run's greedy output; min_new over an EOS; top-k +
     top-p + logprobs 3) on graphs and eager: tokens and logprobs
     byte-identical, the stop retires its request where the greedy stream
     completes it. Per (shape, mode): step ms, replay device ms, capture
     s and the graph pool. c. speculative decoding, k = 2: a self-draft
     sharing the weights, a fresh glm4_9b draft of 4 layers, the
     self-draft at t = 0.8; greedy runs equal the plain greedy graph run
     (near-tie rule on the card's logits; whether bitwise is printed);
     mean_accept_len, tok/s, spec step ms, peak GiB. Phase 2a times the
     chunk kernel at the verify shape (B=8, C=3, ctx up to 2048) against
     its plain version ("verify_" keys of its summary row, with its
     launches inside phase 9c's verify passes, counted around the verify
     call and replay-aware: ``verify_launches``, the replays' part
     ``verify_replayed_launches``).
  10. the rest of the dense family at full width and depth (failing if a
     model does not fit the card), random weights from seed 0, one model
     at a time, each freed before the next: qwen3_32b (64 layers),
     gemma2_27b (46) and starcoder2_3b (30). Phase 3's traffic on CUDA
     graphs and eager (byte-identical greedy tokens); the static path
     (models.api.generate_static: prefill through the flash kernel,
     plain decode attention over dense caches) on the same prompts: the
     logits after the prompts of the static prefill and of the engine
     path are held against an fp32 reading of the same weights (plain
     attention, no kernel), the static path at most twice as far from it
     as the engine path, and its greedy tokens must equal the engine's
     up to a near-tie below the sum of those two distances (or 1e-2);
     a prefill_pack 4 run of the same prompts (4 new tokens), equal to
     the pack-1 run's first 4 up to a near-tie below twice the engine
     path's distance (or 1e-2). gemma2 serves two 6000-token prompts the
     same three ways, past its 4096-key window. Per run: tok/s, decode
     and chunk step ms (wall and device), busy share, TTFT, token gap,
     peak memory and the decode step's bytes floor; each member's
     launches per kernel ("<member>_launches", replay-aware) go into the
     kernels' rows.
  11. abort, the host swap tier, the front end and the fleet, at glm4_9b's
     full width and depth on phase 3's weights and traffic, on CUDA graphs
     (run after phase 9, while those weights are on the card):
     a. 80 allocatable blocks with a 1 GiB pinned host tier, swap_policy
        "always" (graphs and eager), "never" (recompute), and a pool that
        never preempts; then the same three over int8 pools at
        prefill_pack 4: greedy tokens byte-identical in all, >= 2 swap
        preemptions, swapped bytes = blocks x block bytes, every block and
        host slot free at the end; the swap copies' device times per swap
        beside a plain pinned copy_ of the same bytes ("[serve-swap]").
     b. the 8 requests through AsyncEngineDriver over the swap engine:
        when request 0 has 4 tokens it and one waiting request (a swapped
        one if any) are aborted; the other 6 streams equal a run without
        the two, byte for byte ("[serve-abort]").
     c. FrontendServer on 127.0.0.1 (port 0), 8 concurrent SSE clients,
        one gone after 4 tokens: the other 7 equal engine.run()'s tokens,
        one abort, /health 200, /metrics parses as Prometheus text with
        repro_engine_tokens_total == the tokens streamed; TTFT and token
        gap as the clients saw them ("[serve-http]").
     d. ReplicaRouter over 2 engines on the one card sharing the weights
        and a 512-slot SharedPrefixIndex (320 MiB pinned), then with
        disaggregate=True, n_prefill=1: tokens byte-identical to dp = 1,
        blocks published and adopted across replicas; a full-sampling
        request submitted mid-run makes one replica capture its graphs in
        the middle of the other's run (the other's replays timed: some
        before, none inside, under the process-wide device lock, some
        after), and its tokens and logprobs equal its eager run alone;
        tok/s, peak memory and the handoff's bytes and copy time
        ("[serve-fleet]").
     Each run's launches go into the kernels' rows, replay-aware.
     ``python3 chip_smoke.py --phase 11`` runs the build and phase 11
     alone (a development run: no result line).
  Every kernel must have launched on a serving or training path, except
  sampled_softmax_loss, which no model path of either package calls.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or run from a
directory that does not hold the repo, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import faulthandler
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak, same source
TOL = 1e-2
DEV = "cuda"                     # every phase runs on the card
WATCHDOG_S = 1140                # the run's time limit is 1200 s
KV_DTYPES = ("bf16", "int8", "fp8")
DECODE_SRC = "src/repro_torch/csrc/paged_attention.cu"
RAGGED_SRC = "src/repro_torch/csrc/ragged_paged_attention.cu"
SSD_SRC = "src/repro_torch/csrc/ssd.cu"
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
SAMPLED_SRC = "src/repro_torch/csrc/sampled_softmax.cu"
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:203",
            "paged_prefill_attention":
                "src/repro/kernels/paged_attention.py:417",
            "ragged_paged_prefill_attention":
                "src/repro/kernels/paged_attention.py:682",
            "gather": "src/repro/kernels/embedding.py:23",
            "ssd": "src/repro/kernels/ssd.py:80",
            "flash_attention": "src/repro/kernels/flash_attention.py:202",
            "sampled_softmax_loss":
                "src/repro/kernels/sampled_softmax.py:47"}
# the ssd kernel's final state against the plain scan: 1e-3 absolute
# (tests/test_kernels.py's tolerance) where the state is below 1 in
# magnitude, 1e-3 relative above
SSD_H_TOL = 1e-3
# keys of a kernel's row that its summary carries besides the contract's
SUMMARY_EXTRAS = ("kernel_route", "tflops", "floor_ms", "ms_8", "ms_4096",
                  "library_ms_8", "library_ms_4096", "span_ms", "gemm_ms",
                  "gemm_device_ms")
# the flash kernel's lse against the plain logsumexp of the masked logits
LSE_TOL = 1e-3
# sampled-softmax loss, kernel against plain: both sum exact bf16 products
# in fp32, in other orders
SAMPLED_TOL = 1e-4
# ptxas' notes that it serialized a kernel's wgmma.mma_async instructions
# (a silent 25-50% slowdown)
WGMMA_SERIALIZED = ("C7512", "C7518", "C7520")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work on the card: bytes over HBM rate or
    operations over the bf16 peak, whichever is larger. The paged kernels
    dequantize int8/fp8 keys and values to bf16 before the products, so
    their operations count at the bf16 rate."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


# the counter key whose launches keep the kernel's own summary name: the
# bf16 pool for the paged kernels, the hd-128 route for flash attention
MAIN_VARIANT = {"flash_attention": "wgmma"}


def variant(kernel: str, key: str) -> str:
    """Summary name of a kernel's launches under one counter key (a pool
    dtype, or a flash route)."""
    return kernel if key == MAIN_VARIANT.get(kernel, "bf16") \
        else f"{kernel}_{key}"


def kv_row_bytes(kv: str, K: int, hd: int) -> int:
    """Bytes of one token's K (or V) across its kv heads, scales included."""
    return K * (2 * hd if kv == "bf16" else hd + 4)


class Timer:
    """Per-call device time by CUDA events, the L2 cache flushed (a
    256 MB write) before every call, as the engine's 40 layers see it."""

    def __init__(self, torch):
        self.torch = torch
        self.scratch = torch.empty(256 << 20, dtype=torch.uint8,
                                   device=DEV)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.scratch.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def span(self, fn, iters: int = 20, warmup: int = 3) -> float:
        """Device time per call from its first kernel's start to its last
        one's end, gaps included: CUDA events around the call, enqueued
        behind a ~1 ms sleep kernel so that the host's enqueue time is off
        the clock (it is not for __call__); the L2 flushed before each."""
        torch = self.torch
        total = 0.0
        for i in range(warmup + iters):
            self.scratch.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if i >= warmup:
                total += start.elapsed_time(end)
        return total / iters

    def device(self, fn, iters: int = 10) -> float:
        """Device time per call of ``fn`` from a torch.profiler trace: the
        kernels it launches, summed, each call after the same L2 flush;
        the flush's own kernels are left out."""
        return sum(self.kernels(fn, iters).values())

    def kernels(self, fn, iters: int = 10) -> dict:
        """``device``'s time per call by kernel name, in ms."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch

        def traced(f) -> dict:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.scratch.zero_()
                    f()
                torch.cuda.synchronize()
            return {e.key: e.self_device_time_total
                    for e in prof.key_averages()
                    if e.device_type.name == "CUDA"}

        fn()
        flush = traced(lambda: None)
        got = traced(fn)
        return {k: t / iters / 1e3 for k, t in got.items() if k not in flush}


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def paged_case(torch, gen, B, H, K, hd, bs, nb, ctx, C=None):
    """Random bf16 pools, disjoint random block tables, int32 metadata."""
    N = 1 + B * nb
    qshape = (B, H, hd) if C is None else (B, C, H, hd)
    q = torch.randn(qshape, generator=gen, device=DEV).bfloat16()
    kp = torch.randn((N, bs, K, hd), generator=gen, device=DEV).bfloat16()
    vp = torch.randn((N, bs, K, hd), generator=gen, device=DEV).bfloat16()
    perm = torch.randperm(N - 1, generator=gen, device=DEV) + 1
    bt = perm[:B * nb].reshape(B, nb).to(torch.int32).contiguous()
    ctx = torch.tensor(ctx, dtype=torch.int32, device=DEV)
    return q, kp, vp, bt, ctx


def pools_in(kv, kp, vp):
    """bf16 pools -> (k, v, scale keywords) stored as ``kv``."""
    if kv == "bf16":
        return kp, vp, {}
    from repro_torch.models.quant import quantize_kv
    k, ks = quantize_kv(kp, kv)
    v, vs = quantize_kv(vp, kv)
    return k, v, {"k_scale": ks, "v_scale": vs}


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_err(a, b) -> float:
    """Largest relative error over the output rows (one head's hd
    values): ||a - b|| / ||b||. A zero row of b must be zero in a too
    (0/0 counts as 0, x/0 as huge). This scales the tolerance to each
    row, so a long context's small outputs are held as tightly as a short
    one's."""
    import torch
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    rel = (a - b).norm(dim=-1) / b.norm(dim=-1)
    return float(torch.nan_to_num(rel, nan=0.0).max())


def check_close(name: str, a, b) -> tuple[float, float]:
    """Kernel vs plain: every row within TOL relative to its norm, and
    every value within TOL absolute as an outer cap, TOL relative where
    the plain value exceeds 1 in magnitude (there one bf16 ulp of the
    output is 2^-8 relative: 0.0156 between 2 and 4, which rows that see
    only a few keys reach). Returns (max abs err, max row relative
    err)."""
    e, r = err(a, b), row_err(a, b)
    scaled = float(((a.float() - b.float()).abs()
                    / b.float().abs().clamp(min=1.0)).max())
    check(scaled <= TOL and r <= TOL, f"{name}: max abs err {e} ({scaled} "
          f"scaled to max(1, |plain|)), max row relative err {r} (limit "
          f"{TOL})")
    return e, r


def same_bytes(a, b) -> bool:
    import torch
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def timed(timer, kernel, plain, prefix="") -> dict:
    """Event and profiler device times of a kernel and its plain version:
    {prefix}ms, {prefix}device_ms, {prefix}plain_ms,
    {prefix}plain_device_ms."""
    return {f"{prefix}ms": timer(kernel),
            f"{prefix}device_ms": timer.device(kernel),
            f"{prefix}plain_ms": timer(plain),
            f"{prefix}plain_device_ms": timer.device(plain)}


def check_paged(torch, timer, gen, rows):
    """Decode and chunk kernels over every pool dtype (phase 2a)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import paged_chunk_attention_xla

    H, K, hd, bs = 32, 2, 128, 16
    # decode: 8 sequences, contexts up to 2048, one inactive slot
    ctx = [2048, 1536, 1024, 777, 2000, 1, 0, 300]
    B, nb = len(ctx), 2048 // bs
    q, kp16, vp16, bt, ctxt = paged_case(torch, gen, B, H, K, hd, bs, nb,
                                         ctx)
    ones = torch.ones(B, dtype=torch.int32, device=DEV)
    S = sum(ctx)
    for kv in KV_DTYPES:
        kp, vp, sc = pools_in(kv, kp16, vp16)
        o_k = pa.paged_attention(q, kp, vp, bt, ctxt, **sc)
        o_p = ref.paged_attention_ref(q, kp, vp, bt, ctxt, **sc)
        e, rel = check_close(f"paged_attention[{kv}] vs plain", o_k, o_p)
        check(bool((o_k[6] == 0).all()),
              f"paged_attention[{kv}]: ctx=0 row not zero")
        # a one-row chunk is a decode step, bit for bit
        o_c = pa.paged_prefill_attention(q[:, None].contiguous(), kp, vp, bt,
                                         ctxt, ones, **sc)
        check(torch.equal(o_c[:, 0], o_k), f"[{kv}] chunk(C=1) != decode "
              "bitwise")
        check(same_bytes(o_k, pa.paged_attention(q, kp, vp, bt, ctxt, **sc)),
              f"paged_attention[{kv}]: two launches differ")
        b_dec = (2 * q.numel() * 2 + 2 * S * kv_row_bytes(kv, K, hd)
                 + bt.numel() * 4 + B * 4)
        if kv == "bf16":
            split = timer.kernels(lambda: pa.paged_attention(q, kp, vp, bt,
                                                             ctxt))
            print("[kernels] paged_attention device ms by kernel: " + ", ".join(
                f"{k.split('<')[0].split()[-1]} {v:.4f}"
                for k, v in split.items()), flush=True)
        rows[variant("paged_attention", kv)] = dict(
            kernel="paged_attention", source=DECODE_SRC,
            max_abs_err=e, max_row_rel_err=rel,
            **timed(timer, lambda: pa.paged_attention(q, kp, vp, bt, ctxt,
                                                      **sc),
                    lambda: ref.paged_attention_ref(q, kp, vp, bt, ctxt,
                                                    **sc)),
            library_ms=None,
            shape=f"B={B} H={H} K={K} hd={hd} bs={bs} ctx={ctx}",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_dec, 4.0 * S * H * hd))))

    # chunked prefill: one 256-row chunk ending at 2048 tokens, 200 rows
    # valid (the rest are padding and must come out as exact zeros)
    C, qlen, ctx1 = 256, 200, 2048
    q, kp16, vp16, bt, ctxt = paged_case(torch, gen, 1, H, K, hd, bs, nb,
                                         [ctx1], C=C)
    ql = torch.tensor([qlen], dtype=torch.int32, device=DEV)
    keys = sum(ctx1 - qlen + i + 1 for i in range(qlen))   # causal pairs
    for kv in KV_DTYPES:
        kp, vp, sc = pools_in(kv, kp16, vp16)
        o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql, **sc)
        o_p = paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql, **sc)
        e, rel = check_close(f"paged_prefill_attention[{kv}] vs plain",
                             o_k[:, :qlen], o_p[:, :qlen])
        check(bool((o_k[:, qlen:] == 0).all()),
              f"[{kv}] chunk padding rows not zero")
        check(same_bytes(o_k, pa.paged_prefill_attention(q, kp, vp, bt, ctxt,
                                                         ql, **sc)),
              f"paged_prefill_attention[{kv}]: two launches differ")
        b_chk = (2 * q.numel() * 2 + 2 * ctx1 * kv_row_bytes(kv, K, hd)
                 + bt.numel() * 4 + 8)
        rows[variant("paged_prefill_attention", kv)] = dict(
            kernel="paged_prefill_attention", source=DECODE_SRC,
            max_abs_err=e, max_row_rel_err=rel,
            **timed(timer, lambda: pa.paged_prefill_attention(
                        q, kp, vp, bt, ctxt, ql, **sc),
                    lambda: paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql,
                                                      **sc)),
            library_ms=None,
            shape=f"B=1 C={C} q_len={qlen} ctx={ctx1} H={H} K={K} hd={hd}",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_chk, 4.0 * keys * H * hd))))

    # the speculative verify pass at glm4's widths: the chunk kernel over
    # the whole decode batch, k + 1 = 3 rows a sequence, contexts up to
    # 2048 (one slot inactive), bf16 pools
    ctxv = [2048, 1536, 1024, 777, 2000, 3, 0, 300]
    Bv, Cv = len(ctxv), 3
    q, kp, vp, bt, ctxt = paged_case(torch, gen, Bv, H, K, hd, bs, nb, ctxv,
                                     C=Cv)
    ql = torch.tensor([Cv if c else 0 for c in ctxv], dtype=torch.int32,
                      device=DEV)
    o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql)
    o_p = paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql)
    # the plain version averages every value of an empty (ctx 0) row,
    # which the engine discards; the kernel writes zeros there
    act = [i for i, c in enumerate(ctxv) if c]
    e, rel = check_close("paged_prefill_attention verify shape vs plain",
                         o_k[act], o_p[act])
    check(bool((o_k[6] == 0).all()), "verify shape: inactive row not zero")
    keys_v = sum(c - Cv + i + 1 for c in ctxv if c for i in range(Cv))
    b_v = (2 * q.numel() * 2 + 2 * sum(ctxv) * kv_row_bytes("bf16", K, hd)
           + bt.numel() * 4 + 2 * Bv * 4)
    vb = bound_ms(b_v, 4.0 * keys_v * H * hd)
    rows["paged_prefill_attention"].update(
        **timed(timer, lambda: pa.paged_prefill_attention(q, kp, vp, bt, ctxt,
                                                          ql),
                lambda: paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql),
                "verify_"),
        verify_bound_ms=vb[0], verify_bound_by=vb[1], verify_max_abs_err=e,
        verify_max_row_rel_err=rel,
        verify_shape=f"B={Bv} C={Cv} ctx={ctxv} H={H} K={K} hd={hd}")
    r = rows["paged_prefill_attention"]
    print(f"[kernels] chunk kernel at the verify shape (B={Bv}, C={Cv}): "
          f"device {r['verify_device_ms']:.5f} ms (events "
          f"{r['verify_ms']:.5f}), plain device "
          f"{r['verify_plain_device_ms']:.5f}, bound {vb[0]:.5f} "
          f"({vb[1]}), max abs err {e:.3g}", flush=True)

    # zamba2_2p7b's shared attention: H = K = 32 (G = 1), hd = 80, bf16
    # pools (the hybrid runner keeps bf16), decode and a 256-row chunk
    H8, K8, hd8 = 32, 32, 80
    ctx8 = [1024, 700, 300, 1, 0, 512, 999, 64]
    nb8 = 1024 // bs
    q, kp, vp, bt, ctxt = paged_case(torch, gen, len(ctx8), H8, K8, hd8, bs,
                                     nb8, ctx8)
    o_k = pa.paged_attention(q, kp, vp, bt, ctxt)
    e, rel = check_close("paged_attention hd=80 G=1 vs plain", o_k,
                         ref.paged_attention_ref(q, kp, vp, bt, ctxt))
    check(bool((o_k[4] == 0).all()), "paged_attention hd=80: ctx=0 row "
          "not zero")
    row = rows["paged_attention"]
    b_dec = (2 * q.numel() * 2 + 2 * sum(ctx8) * kv_row_bytes("bf16", K8, hd8)
             + bt.numel() * 4 + len(ctx8) * 4)
    hd80 = bound_ms(b_dec, 4.0 * sum(ctx8) * H8 * hd8)
    row.update(**timed(timer, lambda: pa.paged_attention(q, kp, vp, bt, ctxt),
                       lambda: ref.paged_attention_ref(q, kp, vp, bt, ctxt),
                       "hd80_"),
               hd80_bound_ms=hd80[0], hd80_bound_by=hd80[1],
               hd80_max_abs_err=e, hd80_max_row_rel_err=rel,
               hd80_shape=f"B={len(ctx8)} H={H8} K={K8} hd={hd8} bs={bs} "
                          f"ctx={ctx8}")
    C8, qlen8, c8 = 256, 256, 768
    q, kp, vp, bt, ctxt = paged_case(torch, gen, 1, H8, K8, hd8, bs, nb8,
                                     [c8], C=C8)
    ql = torch.tensor([qlen8], dtype=torch.int32, device=DEV)
    o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql)
    e, rel = check_close("paged_prefill_attention hd=80 G=1 vs plain", o_k,
                         paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql))
    keys8 = sum(c8 - qlen8 + i + 1 for i in range(qlen8))
    b_chk = (2 * q.numel() * 2 + 2 * c8 * kv_row_bytes("bf16", K8, hd8)
             + bt.numel() * 4 + 8)
    hd80 = bound_ms(b_chk, 4.0 * keys8 * H8 * hd8)
    rows["paged_prefill_attention"].update(
        **timed(timer, lambda: pa.paged_prefill_attention(q, kp, vp, bt, ctxt,
                                                          ql),
                lambda: paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql),
                "hd80_"),
        hd80_bound_ms=hd80[0], hd80_bound_by=hd80[1], hd80_max_abs_err=e,
        hd80_max_row_rel_err=rel,
        hd80_shape=f"B=1 C={C8} q_len={qlen8} ctx={c8} H={H8} K={K8} "
                   f"hd={hd8}")
    print(f"[kernels] decode and chunk at hd=80, G=1 (zamba2_2p7b): within "
          f"{TOL}", flush=True)

    # window + softcap, multi-sequence chunks with an empty one, at the
    # full head dim and the smoke head dim
    for (Hs, Ks, hds) in ((H, K, hd), (4, 2, 16)):
        q, kp16, vp16, bt, ctxt = paged_case(torch, gen, 3, Hs, Ks, hds, bs,
                                             8, [128, 37, 0], C=40)
        ql = torch.tensor([40, 11, 0], dtype=torch.int32, device=DEV)
        q1 = q[:, 0].contiguous()
        ctx_d = torch.tensor([128, 27, 0], dtype=torch.int32, device=DEV)
        kw = dict(window=50, cap=30.0)
        for kv in KV_DTYPES:
            kp, vp, sc = pools_in(kv, kp16, vp16)
            o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql, **kw,
                                             **sc)
            o_r = ref.paged_prefill_attention_ref(q, kp, vp, bt, ctxt, ql,
                                                  **kw, **sc)
            check_close(f"window+cap chunk hd={hds} [{kv}]", o_k, o_r)
            check(bool((o_k[1, 11:] == 0).all() and (o_k[2] == 0).all()),
                  f"window+cap chunk hd={hds} [{kv}]: padding rows not "
                  "zero")
            o_d = pa.paged_attention(q1, kp, vp, bt, ctx_d, **kw, **sc)
            check_close(f"window+cap decode hd={hds} [{kv}]", o_d,
                        ref.paged_attention_ref(q1, kp, vp, bt, ctx_d, **kw,
                                                **sc))
        print(f"[kernels] window=50 cap=30 hd={hds}: chunk and decode "
              f"within {TOL} over {'/'.join(KV_DTYPES)} pools", flush=True)


# contexts of the bitwise decode == chunk(C=1) cases: the edges of the
# kernel's 64-key steps and 256-key segments (csrc/paged_attention.cuh's
# kStep and kSeg), four segments and three keys, one key, an inactive slot
EDGE_CTX = [63, 65, 255, 257, 1027, 64, 1, 0]
# (H, K, hd): glm4_9b, zamba2_2p7b's shared attention, their smoke heads
HEAD_SHAPES = [(32, 2, 128), (32, 32, 80), (4, 2, 16)]
EDGE_OPTS = [{}, {"window": 50, "cap": 30.0}]
EDGE_CHUNK = 70           # rows of the chunk ending at max(EDGE_CTX)


def check_paged_edges(torch, gen):
    """Phase 2a's bitwise cases, at every head shape, block sizes 8 and 32,
    every pool, without and with window 50 + cap 30: decode ==
    chunk(C=1) at EDGE_CTX; a chunk of EDGE_CHUNK rows ending at 1027
    keys equals one decode step per row; two launches equal; ctx = 0 rows
    exact zeros; both within TOL of the plain decode."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    n, worst = 0, 0.0
    for H, K, hd in HEAD_SHAPES:
        for bs in (8, 32):
            B, nb = len(EDGE_CTX), -(-max(EDGE_CTX) // bs)
            q, kp16, vp16, bt, ctxt = paged_case(torch, gen, B, H, K, hd, bs,
                                                 nb, EDGE_CTX)
            ones = torch.ones(B, dtype=torch.int32, device=DEV)
            # the chunk: sequence 4's table (1027 keys), rows at positions
            # 957..1026; as decode steps, row i sees ctx 958 + i
            C, end = EDGE_CHUNK, max(EDGE_CTX)
            qc = torch.randn((1, C, H, hd), generator=gen,
                             device=DEV).bfloat16()
            btc = bt[4:5].contiguous()
            ctxc = torch.tensor([end], dtype=torch.int32, device=DEV)
            qlc = torch.tensor([C], dtype=torch.int32, device=DEV)
            bt_rows = btc.expand(C, nb).contiguous()
            ctx_rows = torch.arange(end - C + 1, end + 1, dtype=torch.int32,
                                    device=DEV)
            for kv in KV_DTYPES:
                kp, vp, sc = pools_in(kv, kp16, vp16)
                for opts in EDGE_OPTS:
                    name = (f"edges H={H} K={K} hd={hd} bs={bs} [{kv}] "
                            f"{opts or 'no window/cap'}")
                    o_d = pa.paged_attention(q, kp, vp, bt, ctxt, **opts,
                                             **sc)
                    o_c = pa.paged_prefill_attention(
                        q[:, None].contiguous(), kp, vp, bt, ctxt, ones,
                        **opts, **sc)
                    check(torch.equal(o_c[:, 0], o_d),
                          f"{name}: chunk(C=1) != decode")
                    check(same_bytes(o_d, pa.paged_attention(
                        q, kp, vp, bt, ctxt, **opts, **sc)),
                          f"{name}: two decode launches differ")
                    check(bool((o_d[EDGE_CTX.index(0)] == 0).all()),
                          f"{name}: ctx=0 row not zero")
                    worst = max(worst, check_close(
                        f"{name} decode vs plain", o_d,
                        ref.paged_attention_ref(q, kp, vp, bt, ctxt, **opts,
                                                **sc))[1])
                    o_ch = pa.paged_prefill_attention(qc, kp, vp, btc, ctxc,
                                                      qlc, **opts, **sc)
                    o_rows = pa.paged_attention(qc[0], kp, vp, bt_rows,
                                                ctx_rows, **opts, **sc)
                    check(torch.equal(o_ch[0], o_rows),
                          f"{name}: a {C}-row chunk != its rows as decode "
                          "steps")
                    n += 1
    print(f"[kernels] paged edges: decode == chunk(C=1) at ctx {EDGE_CTX} "
          f"and a {EDGE_CHUNK}-row chunk == its rows as decode steps, bit "
          f"for bit, two launches equal, ctx=0 rows zero, over {n} cases "
          f"(heads {HEAD_SHAPES}, bs 8/32, {'/'.join(KV_DTYPES)}, "
          f"{EDGE_OPTS}); decode within {worst:.3g} of plain (row relative)",
          flush=True)


def mma_zero_rows_probe(torch, gen, warps=4096) -> dict:
    """mma.sync m16n8k16 with zero A rows on random bf16 B and random fp32
    C (an eighth of it +0.0 or -0.0): the zero rows' results against C,
    bit for bit. A skipped, fully masked step relies on them being
    equal."""
    import ctypes
    from repro_torch.kernels import build
    vp, i = ctypes.c_void_p, ctypes.c_int
    probe = build.load("paged_attention").paged_mma_zero_rows_probe
    probe.argtypes, probe.restype = [vp] * 4 + [i, vp], i

    def words(n):
        x = torch.randn(2 * n, generator=gen, device=DEV).bfloat16()
        return x.view(torch.int32)

    a, b = words(warps * 128), words(warps * 64)
    c = torch.randn(warps * 128, generator=gen, device=DEV)
    pick = torch.randint(0, 16, c.shape, generator=gen, device=DEV)
    c[pick == 0] = 0.0
    c[pick == 1] = -0.0
    out = torch.empty_like(c)
    rc = probe(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
               warps, build.current_stream(c))
    check(rc == 0, f"mma zero-rows probe launch failed: cudaError {rc}")
    torch.cuda.synchronize()
    zero_rows = (torch.arange(c.numel(), device=DEV) // 32) % 4 < 2
    cz, oz = c[zero_rows], out[zero_rows]
    same = cz.view(torch.int32) == oz.view(torch.int32)
    neg0 = cz.view(torch.int32) == torch.tensor(-0.0).view(torch.int32)
    res = {"values": int(cz.numel()), "bit_equal": int(same.sum()),
           "differ_nonzero_c": int((~same & (cz != 0)).sum()),
           "neg_zero_c": int(neg0.sum()),
           "neg_zero_kept": int((same & neg0).sum()),
           "other_rows_finite": bool(torch.isfinite(out[~zero_rows]).all())}
    print(f"[kernels] mma.sync zero A rows: {res}", flush=True)
    check(res["differ_nonzero_c"] == 0 and res["other_rows_finite"],
          "mma.sync with zero A rows changed a non-zero C value")
    return res


def ragged_inputs(torch, gen, H, K, hd, bs, T, q_lens, ctx):
    """Random packed inputs: q (T, H, hd), bf16 pools, tables, the packing
    of ``q_lens`` into T rows (pack_ragged), new K/V rows (T, K, hd)."""
    import numpy as np
    from repro_torch.serving.engine import pack_ragged
    S, nb = len(q_lens), -(-max(ctx) // bs)
    q, kp16, vp16, bt, ctxt = paged_case(torch, gen, S, H, K, hd, bs, nb,
                                         ctx, C=T)
    _, seq, st, en = (torch.from_numpy(a).to(DEV) for a in pack_ragged(
        [np.zeros(n) for n in q_lens], T, S))
    pad = torch.ones(T, dtype=torch.bool, device=DEV)
    for a, b in zip(st.tolist(), en.tolist()):
        pad[a:b] = False
    check(int(pad.sum()) == T - sum(q_lens), "packing")
    kn16 = torch.randn((T, K, hd), generator=gen, device=DEV).bfloat16()
    vn16 = torch.randn((T, K, hd), generator=gen, device=DEV).bfloat16()
    return dict(q=q[0].contiguous(), kp16=kp16, vp16=vp16,
                seqs=(bt, ctxt, st, en), seq=seq, pad=pad, kn16=kn16,
                vn16=vn16)


def ragged_checks(torch, inp, kv, name, opts=None) -> dict:
    """The packed kernel over one pool dtype, bit for bit: a 1-sequence
    launch equals the chunk kernel, each packed sequence its unpacked
    launch, pool bytes after the fused write the separate scatter, the
    fused output the kernel after that scatter, two launches each other;
    unowned rows exact zeros; within TOL of plain without and with the
    write. ``opts``: window, cap and scale, for every launch. Returns the
    tensors the timings reuse and the errors."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.attention import (ragged_chunk_attention_xla,
                                              update_paged_cache_ragged)
    from repro_torch.models.quant import quantize_kv

    opts = opts or {}
    q, seqs, seq, pad = inp["q"], inp["seqs"], inp["seq"], inp["pad"]
    bt, ctxt, st, en = seqs
    own = ~pad
    zero1 = torch.zeros(1, dtype=torch.int32, device=DEV)
    kp, vp, sc = pools_in(kv, inp["kp16"], inp["vp16"])
    o_k = pa.ragged_paged_prefill_attention(q, kp, vp, *seqs, **sc, **opts)
    check(same_bytes(o_k, pa.ragged_paged_prefill_attention(
        q, kp, vp, *seqs, **sc, **opts)),
          f"{name}: two launches differ")
    o_p = ragged_chunk_attention_xla(q, kp, vp, *seqs, seq, **sc, **opts)
    e_n, rel_n = check_close(f"{name} vs plain", o_k[own], o_p[own])
    check(bool((o_k[pad] == 0).all()), f"{name}: unowned rows not zero")
    # one sequence alone == the chunk kernel; packed == unpacked
    for s, (a, b) in enumerate(zip(st.tolist(), en.tolist())):
        one = torch.zeros_like(q)
        one[:b - a] = q[a:b]
        tab, cx = bt[s:s + 1].contiguous(), ctxt[s:s + 1].contiguous()
        ql = (en - st)[s:s + 1].contiguous()
        o_c = pa.paged_prefill_attention(one[None], kp, vp, tab, cx, ql,
                                         **sc, **opts)[0]
        o_1 = pa.ragged_paged_prefill_attention(one, kp, vp, tab, cx,
                                                zero1, ql, **sc, **opts)
        check(torch.equal(o_1, o_c), f"{name}: S=1 != chunk kernel "
              f"(sequence {s})")
        check(torch.equal(o_k[a:b], o_c[:b - a]),
              f"{name}: packed != unpacked (sequence {s})")
    # the fused write: new rows quantized first, their scale rows in the
    # scale pools before the launch
    kn, vn, nsc = inp["kn16"], inp["vn16"], {}
    if kv != "bf16":
        kn, ksr = quantize_kv(inp["kn16"], kv)
        vn, vsr = quantize_kv(inp["vn16"], kv)
        nsc = {n: update_paged_cache_ragged(sc[n].clone(), r[None], *seqs,
                                            seq)
               for n, r in (("k_scale", ksr), ("v_scale", vsr))}
    k1, v1 = kp.clone(), vp.clone()
    o_w, _, _ = pa.ragged_paged_prefill_attention(
        q, k1, v1, *seqs, k_new=kn, v_new=vn, **nsc, **opts)
    k2 = update_paged_cache_ragged(kp.clone(), kn[None], *seqs, seq)
    v2 = update_paged_cache_ragged(vp.clone(), vn[None], *seqs, seq)
    check(same_bytes(k1[1:], k2[1:]) and same_bytes(v1[1:], v2[1:]),
          f"{name}: pool bytes after the fused write != the scatter")
    check(not same_bytes(k1, kp), f"{name}: the fused write wrote nothing")
    check(torch.equal(o_w, pa.ragged_paged_prefill_attention(
        q, k2, v2, *seqs, **nsc, **opts)),
          f"{name}: fused != scatter + kernel")
    e, rel = check_close(f"{name} fused vs plain", o_w[own],
                         ragged_chunk_attention_xla(q, k2, v2, *seqs, seq,
                                                    **nsc, **opts)[own])
    return dict(kp=kp, vp=vp, sc=sc, k1=k1, v1=v1, k2=k2, v2=v2, kn=kn,
                vn=vn, nsc=nsc, e=e, rel=rel, e_n=e_n, rel_n=rel_n)


# the small packed cases of phase 2b at the other head shapes: a 70-row
# chunk ending at 1027 keys, a decode-like row, a chunk across a segment
# edge, a fresh prompt; 19 rows no sequence owns
RAGGED_SMALL = (160, [70, 1, 50, 20], [1027, 65, 257, 20])


def check_ragged(torch, timer, gen, rows):
    """The packed kernel, without and with the fused write (phase 2b)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.attention import (ragged_chunk_attention_xla,
                                              update_paged_cache_ragged)

    T, q_lens, ctx = RAGGED_SMALL
    for H, K, hd in HEAD_SHAPES[1:]:
        for bs in (8, 32):
            inp = ragged_inputs(torch, gen, H, K, hd, bs, T, q_lens, ctx)
            for kv in KV_DTYPES:
                ragged_checks(torch, inp, kv, f"ragged H={H} K={K} hd={hd} "
                              f"bs={bs} [{kv}]")
    print(f"[kernels] ragged at heads {HEAD_SHAPES[1:]}, bs 8/32, T={T} "
          f"q_lens={q_lens} ctx={ctx}: S=1 == chunk kernel, packed == "
          "unpacked, fused write == scatter (bit for bit) over "
          f"{'/'.join(KV_DTYPES)}", flush=True)

    H, K, hd, bs, T = 32, 2, 128, 16, 512
    q_lens, ctx = [200, 96, 150, 40], [2048, 96, 700, 1000]
    S = len(q_lens)
    inp = ragged_inputs(torch, gen, H, K, hd, bs, T, q_lens, ctx)
    q, seqs, seq = inp["q"], inp["seqs"], inp["seq"]
    bt = seqs[0]
    pairs = sum(n * (c - n) + n * (n + 1) // 2 for n, c in zip(q_lens, ctx))
    flops = 4.0 * pairs * H * hd
    for kv in KV_DTYPES:
        name = f"ragged_paged_prefill_attention[{kv}]"
        r = ragged_checks(torch, inp, kv, name)
        kp, vp, sc, k1, v1, k2, v2 = (r[k] for k in ("kp", "vp", "sc", "k1",
                                                      "v1", "k2", "v2"))
        kn, vn, nsc = r["kn"], r["vn"], r["nsc"]

        def plain_fused():
            update_paged_cache_ragged(k2, kn[None], *seqs, seq)
            update_paged_cache_ragged(v2, vn[None], *seqs, seq)
            return ragged_chunk_attention_xla(q, k2, v2, *seqs, seq, **nsc)

        qb = 2 * q.numel() * 2                      # q read + out written
        rb = kv_row_bytes(kv, K, hd)
        eb = 2 if kv == "bf16" else 1
        meta = bt.numel() * 4 + 3 * S * 4
        b_read = qb + 2 * sum(ctx) * rb + meta
        b_write = (qb + 2 * (sum(ctx) - sum(q_lens)) * K * hd * eb
                   + 2 * sum(ctx) * (rb - K * hd * eb)
                   + 4 * sum(q_lens) * K * hd * eb + meta)
        nw_bound = bound_ms(b_read, flops)
        rows[variant("ragged_paged_prefill_attention", kv)] = dict(
            kernel="ragged_paged_prefill_attention", source=RAGGED_SRC,
            max_abs_err=r["e"], max_row_rel_err=r["rel"],
            **timed(timer, lambda: pa.ragged_paged_prefill_attention(
                        q, k1, v1, *seqs, k_new=kn, v_new=vn, **nsc),
                    plain_fused),
            library_ms=None,
            **timed(timer, lambda: pa.ragged_paged_prefill_attention(
                        q, kp, vp, *seqs, **sc),
                    lambda: ragged_chunk_attention_xla(q, kp, vp, *seqs, seq,
                                                       **sc), "no_write_"),
            no_write_bound_ms=nw_bound[0], no_write_max_abs_err=r["e_n"],
            no_write_max_row_rel_err=r["rel_n"],
            shape=f"T={T} S={S} q_lens={q_lens} ctx={ctx} H={H} K={K} "
                  f"hd={hd} bs={bs}; fused KV write ({pairs} row-key pairs)",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_write, flops))))
        print(f"[kernels] {name}: S=1 == chunk kernel, packed == unpacked, "
              "fused write == scatter (bit for bit)", flush=True)


# id counts of the gather's timings: a decode step, a 256-token chunk, a
# training batch (B x S = 2 x 2048)
GATHER_IDS = (8, 256, 4096)


def check_gather(torch, timer, gen, rows):
    """The gather against table[ids], bit for bit: the full glm4 table at
    1, 8, 256 and 4096 ids, ids 0 and V - 1, out-of-range ids (jnp's rule:
    a negative id counts from the end, then the row is clamped into [0,
    V)); 256- and 8-id rows at
    mamba2_370m's and zamba2_2p7b's tables. Times at 8, 256 and 4096 ids
    beside index_select, by events and from the profiler, and the event
    time of a one-element elementwise launch as the floor (phase 2a)."""
    from repro_torch.kernels import embedding as emb

    V, d = 151552, 4096
    table = torch.randn((V, d), generator=gen, device=DEV).bfloat16()
    ids = {n: torch.randint(0, V, (n,), generator=gen, device=DEV,
                            dtype=torch.int32) for n in (1,) + GATHER_IDS}
    edge = torch.tensor([0, V - 1, -1, V, V + 7, -(2 ** 31), 2 ** 31 - 1,
                         -V, -V - 1, V - 1, 0], dtype=torch.int32,
                        device=DEV)
    cases = [(f"{n} ids", i) for n, i in ids.items()] + [
        ("ids (1, 256)", ids[256].reshape(1, 256)),
        ("ids (8, 1)", ids[8].reshape(8, 1)),
        ("ids 0, V - 1 and out of range", edge)]
    for name, i in cases:
        # jnp's rule: a negative id counts from the end, then clamped
        want = table[torch.where(i < 0, i + V, i).clamp(0, V - 1).long()]
        check(torch.equal(emb.gather(table, i), want),
              f"gather != table[ids] at glm4 ({V}x{d}), {name}")
    # the same two id shapes at the SSM and hybrid models' tables
    from repro_torch.config import get_config
    for arch in ("mamba2_370m", "zamba2_2p7b"):
        c = get_config(arch)
        Va, da = c.padded_vocab_size, c.d_model
        t = torch.randn((Va, da), generator=gen, device=DEV).bfloat16()
        for shape in ((1, 256), (8, 1)):
            i = torch.randint(0, Va, shape, generator=gen, device=DEV,
                              dtype=torch.int32)
            check(torch.equal(emb.gather(t, i), emb.gather_plain(t, i)),
                  f"gather != table[ids] at {arch} ({Va}x{da}), ids {shape}")
        del t
    print("[kernels] gather == table[ids] (bit for bit) at glm4_9b (1, 8, "
          "256, 4096 ids, 0, V - 1 and out-of-range ids), mamba2_370m and "
          "zamba2_2p7b widths", flush=True)
    one = torch.zeros(1, device=DEV)
    times = {"floor_ms": timer(lambda: one.add_(1.0))}
    for n in GATHER_IDS:
        i = ids[n]
        times[f"ms_{n}"] = timer(lambda: emb.gather(table, i))
        times[f"library_ms_{n}"] = timer(lambda: torch.index_select(
            table, 0, i))
        times[f"device_ms_{n}"] = timer.device(lambda: emb.gather(table, i))
        times[f"library_device_ms_{n}"] = timer.device(
            lambda: torch.index_select(table, 0, i))
    print("[kernels] gather times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    i256 = ids[256]
    rows["gather"] = dict(
        kernel="gather", source="src/repro_torch/csrc/embedding.cu",
        max_abs_err=0.0, max_row_rel_err=0.0, ms=times["ms_256"],
        plain_ms=timer(lambda: emb.gather_plain(table, i256)),
        library_ms=times["library_ms_256"],
        shape=f"table {V}x{d} bf16, 256 ids; times at 8 and 4096 ids, "
              "profiler device times and the one-element launch floor in "
              "the other keys",
        **{k: v for k, v in times.items()
           if k not in ("ms_256", "library_ms_256")},
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(2 * 256 * d * 2 + 256 * 4, 0.0))))


def ssd_inputs(torch, gen, b, S, nh, hp, G, N):
    """Inputs drawn as tests/test_kernels.py's SSD cases draw them: x, B,
    C ~ N(0, 1) in bf16, dt ~ U(0.001, 0.1), A ~ -U(0.5, 4), h0 ~ N(0,
    0.5^2) fp32."""
    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=DEV)

    def bf(*shape):
        return torch.randn(shape, generator=gen, device=DEV).bfloat16()

    return (bf(b, S, nh, hp), u((b, S, nh), 0.001, 0.1), -u((nh,), 0.5, 4.0),
            bf(b, S, G, N), bf(b, S, G, N),
            0.5 * torch.randn((b, nh, hp, N), generator=gen, device=DEV))


def ssd_bound(b, S, nh, hp, G, N, Q):
    """Each input read once, each output written once; the operations of
    the causal chunked scan (C.B and scores.xdt over the row pairs j <= i
    of each chunk, the state read-out and update), at the bf16 rate."""
    nbytes = (2 * b * S * nh * hp * 2 + b * S * nh * 4 + nh * 4
              + 2 * b * S * G * N * 2 + 2 * b * nh * hp * N * 4)
    nc = S // Q
    flops = b * nh * nc * (Q * (Q + 1) * (N + hp) + 4 * Q * N * hp)
    return bound_ms(nbytes, flops), flops


def check_ssd_close(name, y_k, h_k, y_p, h_p) -> tuple[float, float, float]:
    """y: every (row, head) within TOL relative to its norm; h_last within
    SSD_H_TOL of max(1, |plain|). Returns (y abs err, y row rel err,
    h abs err)."""
    ey, ry = err(y_k, y_p), row_err(y_k, y_p)
    eh = err(h_k, h_p)
    scaled = float(((h_k - h_p).abs() / h_p.abs().clamp(min=1.0)).max())
    check(ry <= TOL and scaled <= SSD_H_TOL,
          f"{name}: y max row relative err {ry} (limit {TOL}), h_last max "
          f"err {eh} ({scaled} scaled to max(1, |plain|); limit "
          f"{SSD_H_TOL})")
    return ey, ry, eh


def check_ssd(torch, timer, gen, rows):
    """The SSD scan kernel against ssd_chunked at both models' widths,
    and its two bitwise invariants (phase 2c)."""
    from repro_torch.kernels import ssd as ssd_k
    from repro_torch.models.ssm import ssd_chunked

    Q = 256
    widths = {"mamba2_370m": (32, 64, 1, 128), "zamba2_2p7b": (80, 64, 1, 64)}
    for arch, (nh, hp, G, N) in widths.items():
        for b, S in ((1, Q), (2, 2 * Q)):
            x, dt, A, B, C, h0 = ssd_inputs(torch, gen, b, S, nh, hp, G, N)
            y_k, h_k = ssd_k.ssd(x, dt, A, B, C, chunk=Q, h0=h0)
            y_p, h_p = ssd_chunked(x, dt, A, B, C, Q, h0=h0)
            e = check_ssd_close(f"ssd {arch} b={b} S={S}", y_k, h_k, y_p, h_p)
            if arch == "mamba2_370m" and b == 1:
                main = (x, dt, A, B, C, h0, e)
    # the smoke widths and a grouped case (G = 2), without h0
    for (b, S, nh, hp, G, N, q) in ((2, 16, 4, 16, 1, 16, 8),
                                    (2, 96, 4, 32, 2, 16, 16)):
        x, dt, A, B, C, _ = ssd_inputs(torch, gen, b, S, nh, hp, G, N)
        check_ssd_close(f"ssd b={b} S={S} nh={nh} hp={hp} G={G} N={N} Q={q}",
                        *ssd_k.ssd(x, dt, A, B, C, chunk=q),
                        *ssd_chunked(x, dt, A, B, C, q))

    # (a) one launch over 2Q rows == two launches of Q, h0 carried
    nh, hp, G, N = widths["mamba2_370m"]
    x, dt, A, B, C, h0 = ssd_inputs(torch, gen, 1, 2 * Q, nh, hp, G, N)
    y2, h2 = ssd_k.ssd(x, dt, A, B, C, chunk=Q, h0=h0)
    halves = [t[:, :Q].contiguous() for t in (x, dt, B, C)]
    ya, ha = ssd_k.ssd(halves[0], halves[1], A, halves[2], halves[3],
                       chunk=Q, h0=h0)
    rest = [t[:, Q:].contiguous() for t in (x, dt, B, C)]
    yb, hb = ssd_k.ssd(rest[0], rest[1], A, rest[2], rest[3], chunk=Q, h0=ha)
    check(torch.equal(y2, torch.cat([ya, yb], dim=1)) and torch.equal(h2, hb),
          "ssd: one launch over 2Q rows != two launches of Q, bit for bit")
    # ... and under CUDA-graph replay, where the capture turns the scan's
    # programmatic dependent launch into a graph edge
    (y2r, h2r), g_one = graph_replay(torch, lambda: ssd_k.ssd(
        x, dt, A, B, C, chunk=Q, h0=h0))

    def two_launches():
        ya, ha = ssd_k.ssd(*halves[:2], A, *halves[2:], chunk=Q, h0=h0)
        yb, hb = ssd_k.ssd(*rest[:2], A, *rest[2:], chunk=Q, h0=ha)
        return torch.cat([ya, yb], dim=1), hb

    (yabr, hbr), _ = graph_replay(torch, two_launches)
    check(torch.equal(y2r, y2) and torch.equal(h2r, h2)
          and torch.equal(yabr, y2) and torch.equal(hbr, h2),
          "ssd under graph replay: 2Q in one launch, two launches of Q and "
          "the eager launches differ, bit for bit")
    edges = graph_edge_types(g_one)
    # (b) rows with dt = 0 past row n: whatever they hold, h_last and the
    # first n rows' y are unchanged; a whole chunk of them is the identity
    n = 100
    x, dt, A, B, C, h0 = ssd_inputs(torch, gen, 1, Q, nh, hp, G, N)
    dt[:, n:] = 0.0
    y1, h1 = ssd_k.ssd(x, dt, A, B, C, chunk=Q, h0=h0)
    x2, _, _, B2, C2, _ = ssd_inputs(torch, gen, 1, Q, nh, hp, G, N)
    for t, t2 in ((x, x2), (B, B2), (C, C2)):
        t2[:, :n] = t[:, :n]
    y2, h2 = ssd_k.ssd(x2, dt, A, B2, C2, chunk=Q, h0=h0)
    check(torch.equal(h1, h2) and torch.equal(y1[:, :n], y2[:, :n]),
          "ssd: dt = 0 rows changed h_last or earlier rows' y")
    (y1r, h1r), _ = graph_replay(torch, lambda: ssd_k.ssd(
        x, dt, A, B, C, chunk=Q, h0=h0))
    (y2r, h2r), _ = graph_replay(torch, lambda: ssd_k.ssd(
        x2, dt, A, B2, C2, chunk=Q, h0=h0))
    check(torch.equal(y1r, y1) and torch.equal(h1r, h1)
          and torch.equal(h2r, h1) and torch.equal(y2r[:, :n], y1[:, :n]),
          "ssd under graph replay: dt = 0 rows changed h_last or earlier "
          "rows' y, or the replay differs from the eager launch")
    zero_chunk = [torch.cat([t, t2], dim=1) for t, t2 in ((x, x2), (B, B2),
                                                           (C, C2))]
    dt_z = torch.cat([dt, torch.zeros_like(dt)], dim=1)
    y3, h3 = ssd_k.ssd(zero_chunk[0], dt_z, A, zero_chunk[1], zero_chunk[2],
                       chunk=Q, h0=h0)
    check(torch.equal(h3, h1) and torch.equal(y3[:, :Q], y1),
          "ssd: a chunk of dt = 0 rows is not the identity on the state")
    print("[kernels] ssd: 2Q in one launch == two launches of Q, dt = 0 "
          "rows leave h_last and earlier y unchanged (bit for bit), eager "
          "and under CUDA-graph replay (== eager); the one-launch graph's "
          f"edges by type (0 full, 1 programmatic): {edges}", flush=True)

    x, dt, A, B, C, h0, (ey, ry, eh) = main
    b, S = x.shape[:2]
    (bnd, by), flops = ssd_bound(b, S, nh, hp, G, N, Q)
    zb = widths["zamba2_2p7b"]
    xz, dtz, Az, Bz, Cz, h0z = ssd_inputs(torch, gen, 1, Q, *zb)

    def kernel():
        return ssd_k.ssd(x, dt, A, B, C, chunk=Q, h0=h0)

    def kernel_z():
        return ssd_k.ssd(xz, dtz, Az, Bz, Cz, chunk=Q, h0=h0z)

    rows["ssd"] = dict(
        kernel="ssd", source=SSD_SRC, max_abs_err=ey, max_row_rel_err=ry,
        h_last_max_abs_err=eh, library_ms=None, bound_ms=bnd, bound_by=by,
        fp32_cuda_core_ms=flops / 67e12 * 1e3,
        **timed(timer, kernel, lambda: ssd_chunked(x, dt, A, B, C, Q, h0=h0)),
        **timed(timer, kernel_z,
                lambda: ssd_chunked(xz, dtz, Az, Bz, Cz, Q, h0=h0z),
                prefix="zamba2_"),
        span_ms=timer.span(kernel), zamba2_span_ms=timer.span(kernel_z),
        device_ms_by_kernel=timer.kernels(kernel),
        zamba2_bound_ms=ssd_bound(1, Q, *zb, Q)[0][0],
        shape=f"b={b} S={S} nh={nh} hp={hp} G={G} N={N} Q={Q} "
              f"({flops / 1e9:.3f} GFLOP); zamba2 nh={zb[0]} N={zb[3]}")


def graph_replay(torch, fn):
    """``fn``'s outputs from a CUDA graph of it: one eager warm-up call on
    a side stream, the capture (kept for ``graph_edge_types``), one
    replay. Returns (outputs, graph)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        out = fn()
    g.instantiate()
    g.replay()
    torch.cuda.synchronize()
    return out, g


def causal_pairs(Sq, Skv, causal, window, q_offset) -> int:
    """(query row, key) pairs the mask lets through."""
    if not causal:
        return Sq * Skv
    n = 0
    for i in range(Sq):
        hi = min(Skv, q_offset + i + 1)
        lo = 0 if window is None else max(0, q_offset + i - window + 1)
        n += max(0, hi - lo)
    return n


# name, B, Sq, Skv, H, K, hd, causal, window, cap, q_offset: glm4_9b's
# attention at chip_smoke's training shape (B=2, S=2048) and its variants
FLASH_CASES = [
    ("glm4 causal", 2, 2048, 2048, 32, 2, 128, True, None, None, 0),
    ("glm4 window 512 cap 50", 2, 2048, 2048, 32, 2, 128, True, 512, 50.0, 0),
    ("glm4 Sq 256 at q_offset 1792", 2, 256, 2048, 32, 2, 128, True, None,
     None, 1792),
    ("glm4 non-causal Sq 200", 2, 200, 2048, 32, 2, 128, False, None, None,
     0),
    ("hd 16 window 64 cap 30", 2, 300, 300, 4, 2, 16, True, 64, 30.0, 0),
    # the edges of the hd-128 route's 128-row and 128-key tiles
    ("Sq 129 causal", 2, 129, 129, 32, 2, 128, True, None, None, 0),
    ("Sq 255 causal", 2, 255, 255, 32, 2, 128, True, None, None, 0),
    ("Skv 130 non-causal", 2, 96, 130, 32, 2, 128, False, None, None, 0),
    ("Sq 148 at q_offset 1900", 2, 148, 2048, 32, 2, 128, True, None, None,
     1900),
    ("window 100 cap 50", 2, 600, 600, 32, 2, 128, True, 100, 50.0, 0)]
# glm4_9b's head (V, d), the sampled ids n and the rows T of phase 2e
SAMPLED_SHAPE = (151552, 4096, 8192, 4096)


def check_flash(torch, timer, gen, rows):
    """The flash forward kernel against dense_attention (o) and the plain
    logsumexp (lse); FlashAttention's gradients against autograd through
    dense_attention; two launches give the same bits (phase 2d)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import dense_attention

    for (name, B, Sq, Skv, H, K, hd, causal, window, cap, off) in FLASH_CASES:
        q = torch.randn((B, Sq, H, hd), generator=gen, device=DEV).bfloat16()
        k = torch.randn((B, Skv, K, hd), generator=gen, device=DEV).bfloat16()
        v = torch.randn((B, Skv, K, hd), generator=gen, device=DEV).bfloat16()
        opts = dict(causal=causal, window=window, cap=cap, q_offset=off)
        o_k, lse_k = fa.flash_attention(q, k, v, **opts)
        o_2, lse_2 = fa.flash_attention(q, k, v, **opts)
        check(same_bytes(o_k, o_2) and same_bytes(lse_k, lse_2),
              f"flash {name}: two launches differ")
        e, rel = check_close(f"flash {name} vs dense_attention", o_k,
                             dense_attention(q, k, v, **opts))
        o_p, lse_p = ref.flash_attention_fwd_plain(q, k, v, **opts)
        e_lse = err(lse_k, lse_p)
        check(e_lse <= LSE_TOL, f"flash {name}: lse max abs err {e_lse} "
              f"(limit {LSE_TOL})")
        # gradients: the kernel forward + plain backward against autograd
        # through dense_attention (bf16 probabilities), each within TOL of
        # that gradient's largest magnitude
        do = torch.randn((B, Sq, H, hd), generator=gen, device=DEV).bfloat16()
        grads = []
        for attend in (lambda *a: fa.FlashAttention.apply(
                           *a, causal, window, cap, None, off),
                       lambda *a: dense_attention(*a, **opts)):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            attend(*leaves).backward(do)
            grads.append([t.grad for t in leaves])
            del leaves
        g_err = []
        for gname, a, b in zip("qkv", *grads):
            big = float(b.float().abs().max())
            g_err.append(err(a, b) / big)
            check(g_err[-1] <= TOL, f"flash {name}: d{gname} max abs err "
                  f"{err(a, b)} (limit {TOL} x max |d{gname}| {big})")
        del grads
        print(f"[kernels] flash {name} (route {fa.route(hd)}): o max row "
              f"rel err {rel:.3g}, lse max abs err {e_lse:.3g}, dq/dk/dv "
              f"err / max {g_err}, two launches bit-equal", flush=True)
        if hd == 16:
            mma_ms = timer(lambda: fa.flash_attention(q, k, v, **opts))
            mma_shape = f"{name}: B={B} Sq={Sq} Skv={Skv} H={H} K={K}"
            print(f"[kernels] flash route mma (hd 16) at {mma_shape}: "
                  f"{mma_ms:.4f} ms", flush=True)
        if name != "glm4 causal":
            continue
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = causal_pairs(Sq, Skv, causal, window, off)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) \
            + 4 * lse_k.numel()
        bwd_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o_b = fa.FlashAttention.apply(*bwd_leaves, causal, window, cap, None,
                                      off)
        flops = 4.0 * B * H * hd * pairs

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        ms = timer(lambda: fa.flash_attention(q, k, v, **opts))
        main = dict(
            kernel="flash_attention", source=FLASH_SRC, max_abs_err=e,
            max_row_rel_err=rel, lse_max_abs_err=e_lse,
            grad_err_over_max=g_err, kernel_route=fa.route(hd), ms=ms,
            tflops=flops / ms * 1e-9,
            device_ms=timer.device(lambda: fa.flash_attention(q, k, v,
                                                              **opts)),
            plain_ms=timer(lambda: ref.flash_attention_fwd_plain(
                q, k, v, **opts)),
            library_ms=timer(sdpa), library_device_ms=timer.device(sdpa),
            bwd_plain_ms=timer(lambda: torch.autograd.grad(
                o_b, bwd_leaves, do, retain_graph=True), iters=5),
            shape=f"B={B} Sq={Sq} Skv={Skv} H={H} K={K} hd={hd} causal "
                  f"({pairs} row-key pairs per batch row, "
                  f"{flops / 1e9:.1f} GFLOP)",
            **dict(zip(("bound_ms", "bound_by"), bound_ms(nbytes, flops))))
        del bwd_leaves, o_b
    main.update(mma_route_ms=mma_ms, mma_route_shape=mma_shape,
                scaling=flash_scaling(torch, timer, gen))
    rows["flash_attention"] = main


# B, Sq, Skv, causal at glm4's heads (H=32, K=2, hd 128): one key tile per
# block and sixteen (the per-block cost and the per-tile cost), and a long
# causal sequence
FLASH_SCALING = [(2, 2048, 128, False), (2, 2048, 2048, False),
                 (1, 8192, 8192, True)]


def flash_scaling(torch, timer, gen) -> list:
    """The hd-128 route beside scaled_dot_product_attention at other
    shapes: event and profiler times, TFLOP/s, and the profiler time per
    block slot (x 132 SMs / blocks), which says what one 128-row block
    costs at each key count."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    out = []
    for B, Sq, Skv, causal in FLASH_SCALING:
        H, K, hd = 32, 2, 128
        q = torch.randn((B, Sq, H, hd), generator=gen, device=DEV).bfloat16()
        k = torch.randn((B, Skv, K, hd), generator=gen, device=DEV).bfloat16()
        v = torch.randn((B, Skv, K, hd), generator=gen, device=DEV).bfloat16()
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops = 4.0 * B * H * hd * causal_pairs(Sq, Skv, causal, None, 0)

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        r = dict(B=B, Sq=Sq, Skv=Skv, causal=causal, ms=timer(kernel),
                 device_ms=timer.device(kernel), library_ms=timer(sdpa),
                 library_device_ms=timer.device(sdpa))
        r["tflops"] = flops / r["ms"] * 1e-9
        r["library_tflops"] = flops / r["library_ms"] * 1e-9
        r["us_per_block_slot"] = 1e3 * r["device_ms"] * 132 / (
            B * H * -(-Sq // 128))
        print(f"[kernels] flash wgmma B={B} Sq={Sq} Skv={Skv} causal="
              f"{causal}: {r['ms']:.4f} ms ({r['tflops']:.0f} TFLOP/s), "
              f"device {r['device_ms']:.4f} ms, {r['us_per_block_slot']:.2f} "
              f"us per block slot; SDPA {r['library_ms']:.4f} ms "
              f"({r['library_tflops']:.0f} TFLOP/s)", flush=True)
        out.append(r)
    return out


def sampled_inputs(torch, gen, V, d, n, T):
    """A (V, d) bf16 table scaled by d^-0.5, n distinct sampled ids, x
    (T, d) bf16 and labels (T,), the first 8 labels set to sampled ids
    (accidental hits)."""
    table = (torch.randn((V, d), generator=gen, device=DEV)
             * d ** -0.5).bfloat16()
    sids = torch.randperm(V, generator=gen, device=DEV)[:n].to(torch.int32)
    x = torch.randn((T, d), generator=gen, device=DEV).bfloat16()
    labels = torch.randint(0, V, (T,), generator=gen, device=DEV,
                           dtype=torch.int32)
    labels[:8] = sids[:8]
    return table, sids, x, labels


def check_sampled_case(torch, name, x, table, labels, sids, cap):
    """One phase 2e case: kernel within SAMPLED_TOL relative of the plain
    loss, two launches bit-equal. Returns (abs err, relative err)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sampled_softmax as ss
    l_k = ss.sampled_softmax_loss(x, table, labels, sids, cap=cap)
    l_2 = ss.sampled_softmax_loss(x, table, labels, sids, cap=cap)
    check(same_bytes(l_k.reshape(1), l_2.reshape(1)),
          f"{name}: two launches differ")
    l_p = ref.sampled_softmax_loss_ref(x, table, labels, sids, cap=cap)
    e = abs(float(l_k) - float(l_p))
    rel = e / abs(float(l_p))
    check(rel <= SAMPLED_TOL, f"{name}: kernel {float(l_k)} plain "
          f"{float(l_p)}, relative err {rel} (limit {SAMPLED_TOL})")
    print(f"[kernels] {name}: loss {float(l_k):.6f} plain {float(l_p):.6f} "
          f"rel err {rel:.3g}, two launches bit-equal", flush=True)
    return e, rel


# phase 2e's cases besides the main shape's four: the edges of the GEMM
# launch's 128-row and 256-column tiles at glm4's head (the main table,
# the first n sampled ids, the first T rows), and zamba2_2p7b's head
# (32000 x 2560: 40 steps of 64 over d); name, n, T, cap, (V, d) or None
SAMPLED_EDGES = [("n not a multiple of 256", 8000, 4096, None, None),
                 ("n below one column tile", 64, 4096, 30.0, None),
                 ("T below one row tile", 8192, 100, None, None),
                 ("zamba2's head, d=2560", 8192, 4096, 30.0, (32000, 2560))]


def check_sampled_softmax(torch, timer, gen, rows):
    """The sampled-softmax kernel against its plain version at glm4's
    head (151552 x 4096 bf16), n = 8192 sampled ids, T = 4096 and 4095,
    no cap and cap 30, then SAMPLED_EDGES, accidental hits planted
    (phase 2e); its per-launch device times and cuBLAS's bf16 product of
    the same shape (gemm_ms, a yardstick the port never calls)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sampled_softmax as ss

    V, d, n, T0 = SAMPLED_SHAPE
    table, sids, x_all, lab_all = sampled_inputs(torch, gen, V, d, n, T0)
    for T in (T0, T0 - 1):
        for cap in (None, 30.0):
            e, rel = check_sampled_case(
                torch, f"sampled_softmax_loss T={T} cap={cap}", x_all[:T],
                table, lab_all[:T], sids, cap)
            if T == T0 and cap is None:
                main = (e, rel)
    for name, n_e, T, cap, head in SAMPLED_EDGES:
        if head is None:
            args = (x_all[:T], table, lab_all[:T], sids[:n_e])
        else:
            t_e, s_e, x_e, l_e = sampled_inputs(torch, gen, *head, n_e, T)
            args = (x_e, t_e, l_e, s_e)
        check_sampled_case(torch, f"sampled_softmax_loss {name}: "
                           f"T={T} n={n_e} cap={cap}", *args, cap)
    e, rel = main
    x, labels, T = x_all, lab_all, T0
    nbytes = 2 * (T * d + T * d + n * d) + 4 * (T + n) + 4
    flops = 2.0 * T * n * d

    def kernel():
        return ss.sampled_softmax_loss(x, table, labels, sids)

    w_samp = table[sids.long()]
    by_kernel = timer.kernels(kernel)
    gemm = [v for k, v in by_kernel.items() if "sampled_lse_kernel" in k]
    check(len(gemm) == 1, f"sampled_softmax_loss: no single GEMM launch "
          f"in the profile: {sorted(by_kernel)}")
    rows["sampled_softmax_loss"] = dict(
        kernel="sampled_softmax_loss", source=SAMPLED_SRC, max_abs_err=e,
        max_row_rel_err=rel, library_ms=None,
        **timed(timer, kernel,
                lambda: ref.sampled_softmax_loss_ref(x, table, labels, sids)),
        device_ms_by_kernel=by_kernel, tflops=flops / (gemm[0] * 1e9),
        gemm_ms=timer(lambda: torch.mm(x, w_samp.t())),
        gemm_device_ms=timer.device(lambda: torch.mm(x, w_samp.t())),
        shape=f"T={T} d={d} n={n}, table {V}x{d} bf16 (gathers included; "
              "loss relative error in max_row_rel_err; tflops: the GEMM "
              "launch alone)",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(nbytes, flops + 2.0 * T * d))))
    r = rows["sampled_softmax_loss"]
    print(f"[kernels] sampled_softmax_loss device ms by kernel: "
          f"{json.dumps(by_kernel)}; GEMM launch {r['tflops']:.1f} TFLOP/s; "
          f"torch.mm of the same shape (cuBLAS, yardstick): events "
          f"{r['gemm_ms']:.5f} ms, device {r['gemm_device_ms']:.5f} ms",
          flush=True)


# the kernels of the family's serving path (bf16 pools, the flash kernel's
# hd-128 route), whose rows carry each member's numbers
FAMILY_KERNELS = ("paged_attention", "paged_prefill_attention",
                  "ragged_paged_prefill_attention", "flash_attention",
                  "gather")
# phase 2f: the paged, flash and gather kernels at the heads and tables of
# the rest of the dense family (hd 128): name -> (arch, H, K, the layer
# options of its windowed layers). gemma2_27b's local layers: a 4096-key
# window, attention softcap 50, scale 144^-0.5 (its global layers drop
# the window); qwen3_32b and starcoder2_3b: causal, hd^-0.5
FAMILY = {"gemma2": ("gemma2_27b", 32, 16,
                     dict(window=4096, cap=50.0, scale=144 ** -0.5)),
          "qwen3": ("qwen3_32b", 64, 8, {}),
          "starcoder2": ("starcoder2_3b", 24, 2, {})}
# decode contexts (8 sequences, one inactive) and the chunk's end: past
# gemma2's window, glm4's lengths for the others
FAMILY_CTX = {"gemma2": ([6144, 6000, 4097, 4095, 5000, 1, 0, 300], 6144),
              "qwen3": ([2048, 1536, 1024, 777, 2000, 1, 0, 300], 2048),
              "starcoder2": ([2048, 1536, 1024, 777, 2000, 1, 0, 300], 2048)}
# packed: phase 2b's q_lens at these contexts (gemma2's first past the
# window)
FAMILY_PACKED = {"gemma2": [6144, 96, 4700, 5000],
                 "qwen3": [2048, 96, 700, 1000],
                 "starcoder2": [2048, 96, 700, 1000]}
# flash: (B, S) per family member, the member's layer options. The first
# is the row's timed shape (gemma2 at a long prompt past its window, the
# others causal at 2048); the rest are the shapes phase 10's static path
# gives the kernel: its 8 x 512 prompts, and gemma2's two 6000-token
# prompts (a partial last 128-row tile)
FAMILY_FLASH = {"gemma2": [(1, 6144), (8, 512), (2, 6000)],
                "qwen3": [(1, 2048), (8, 512)],
                "starcoder2": [(1, 2048), (8, 512)]}


def visible_keys(pos: int, window) -> int:
    """Keys a query at absolute position ``pos`` sees."""
    return pos + 1 if window is None else min(pos + 1, window)


def family_row(rows, kernel, prefix, **kw) -> None:
    """A family member's numbers as ``prefix``-ed keys of a kernel's
    row."""
    rows[kernel].update({prefix + k: v for k, v in kw.items()})


def check_family_flash(torch, timer, gen, arch, H, K, hd, variants, B, S,
                       F, fa, ref, dense_attention) -> dict:
    """The flash forward at one family shape, for each of the member's
    layer options (``variants``; the first is timed): two launches
    bit-equal, o within TOL of dense_attention, lse within LSE_TOL of the
    plain one; the first's times (SDPA's where SDPA computes the same
    function) and bound."""
    q = torch.randn((B, S, H, hd), generator=gen, device=DEV).bfloat16()
    k = torch.randn((B, S, K, hd), generator=gen, device=DEV).bfloat16()
    v = torch.randn((B, S, K, hd), generator=gen, device=DEV).bfloat16()
    for o in reversed(variants):
        fo = dict(causal=True, **o)
        o_k, lse_k = fa.flash_attention(q, k, v, **fo)
        o_2, lse_2 = fa.flash_attention(q, k, v, **fo)
        check(same_bytes(o_k, o_2) and same_bytes(lse_k, lse_2),
              f"flash {arch} B={B} S={S} {o}: two launches differ")
        del o_2, lse_2
        e, rel = check_close(f"flash {arch} B={B} S={S} {o} vs "
                             "dense_attention", o_k,
                             dense_attention(q, k, v, **fo))
        e_lse = err(lse_k, ref.flash_attention_fwd_plain(q, k, v, **fo)[1])
        check(e_lse <= LSE_TOL, f"flash {arch} B={B} S={S} {o}: lse max abs "
              f"err {e_lse} (limit {LSE_TOL})")
    opts = variants[0]
    pairs = causal_pairs(S, S, True, opts.get("window"), 0)
    flops = 4.0 * B * H * hd * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse_k.numel()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    ms = timer(lambda: fa.flash_attention(q, k, v, **fo))
    if opts:
        # SDPA has no softcap: no library call computes gemma2's function;
        # SDPA's causal time on the same tensors is a yardstick only
        lib = dict(library_ms=None, sdpa_causal_no_cap_ms=timer(sdpa))
    else:
        lib = dict(library_ms=timer(sdpa), library_device_ms=timer.device(sdpa))
    return dict(
        max_abs_err=e, max_row_rel_err=rel, lse_max_abs_err=e_lse, ms=ms,
        tflops=flops / ms * 1e-9,
        device_ms=timer.device(lambda: fa.flash_attention(q, k, v, **fo)),
        plain_ms=timer(lambda: ref.flash_attention_fwd_plain(q, k, v, **fo),
                       iters=5),
        shape=f"{arch}: B={B} S={S} H={H} K={K} hd={hd} causal {opts} "
              f"({pairs} row-key pairs per batch row)",
        **lib, **dict(zip(("bound_ms", "bound_by"), bound_ms(nbytes, flops))))


def check_family(torch, timer, gen, rows):
    """Phase 2f: decode, chunk and packed kernels at each member's (H, K)
    over bf16 pools with its windowed layers' options (and gemma2's global
    layers without the window): within TOL of the plain versions, decode
    == chunk(C=1), packed S=1 == chunk, packed == unpacked, fused write ==
    scatter, bit for bit; the flash forward vs dense_attention (its lse
    vs the plain one) at the member's long prompt and at phase 10's static
    prefill shapes, beside SDPA where SDPA computes the same function; the
    gather == table[ids] at each member's embedding table.
    Times, bounds and errors go into each kernel's row under the member's
    prefix ("gemma2_", "qwen3_", "starcoder2_")."""
    import torch.nn.functional as F
    from repro_torch.config import get_config
    from repro_torch.kernels import embedding as emb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import (dense_attention,
                                              paged_chunk_attention_xla,
                                              ragged_chunk_attention_xla)

    hd, bs = 128, 16
    for name, (arch, H, K, opts) in FAMILY.items():
        p = name + "_"
        window = opts.get("window")
        ctx, c_end = FAMILY_CTX[name]
        B, nb = len(ctx), -(-max(ctx) // bs)
        q, kp, vp, bt, ctxt = paged_case(torch, gen, B, H, K, hd, bs, nb,
                                         ctx)
        ones = torch.ones(B, dtype=torch.int32, device=DEV)
        # gemma2's global layers: cap and scale, no window (checked only)
        variants = [opts] + ([{k: v for k, v in opts.items()
                               if k != "window"}] if window else [])
        for o in variants:
            o_k = pa.paged_attention(q, kp, vp, bt, ctxt, **o)
            e, rel = check_close(f"paged_attention {name} {o} vs plain", o_k,
                                 ref.paged_attention_ref(q, kp, vp, bt, ctxt,
                                                         **o))
            check(bool((o_k[ctx.index(0)] == 0).all()),
                  f"paged_attention {name}: ctx=0 row not zero")
            o_c = pa.paged_prefill_attention(q[:, None].contiguous(), kp, vp,
                                             bt, ctxt, ones, **o)
            check(torch.equal(o_c[:, 0], o_k),
                  f"{name} {o}: chunk(C=1) != decode bitwise")
        keys = sum(visible_keys(c - 1, window) for c in ctx if c)
        b_dec = (2 * q.numel() * 2 + 2 * keys * kv_row_bytes("bf16", K, hd)
                 + bt.numel() * 4 + B * 4)
        e, rel = check_close(f"paged_attention {name} vs plain",
                             pa.paged_attention(q, kp, vp, bt, ctxt, **opts),
                             ref.paged_attention_ref(q, kp, vp, bt, ctxt,
                                                     **opts))
        family_row(
            rows, "paged_attention", p, max_abs_err=e, max_row_rel_err=rel,
            shape=f"{arch}: B={B} H={H} K={K} hd={hd} bs={bs} ctx={ctx} "
                  f"{opts}",
            **timed(timer, lambda: pa.paged_attention(q, kp, vp, bt, ctxt,
                                                      **opts),
                    lambda: ref.paged_attention_ref(q, kp, vp, bt, ctxt,
                                                    **opts)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_dec, 4.0 * keys * H * hd))))

        # a 256-row chunk, 200 rows valid, ending at c_end
        C, qlen = 256, 200
        q, kp, vp, bt, ctxt = paged_case(torch, gen, 1, H, K, hd, bs, nb,
                                         [c_end], C=C)
        ql = torch.tensor([qlen], dtype=torch.int32, device=DEV)
        for o in variants:
            o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql, **o)
            e, rel = check_close(
                f"paged_prefill_attention {name} {o} vs plain",
                o_k[:, :qlen], paged_chunk_attention_xla(
                    q, kp, vp, bt, ctxt, ql, **o)[:, :qlen])
            check(bool((o_k[:, qlen:] == 0).all()),
                  f"{name}: chunk padding rows not zero")
        pos0 = c_end - qlen
        pairs = sum(visible_keys(pos0 + i, window) for i in range(qlen))
        span = c_end - (0 if window is None else max(0, pos0 - window + 1))
        b_chk = (2 * q.numel() * 2 + 2 * span * kv_row_bytes("bf16", K, hd)
                 + bt.numel() * 4 + 8)
        e, rel = check_close(
            f"paged_prefill_attention {name} vs plain",
            pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql,
                                       **opts)[:, :qlen],
            paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql,
                                      **opts)[:, :qlen])
        family_row(
            rows, "paged_prefill_attention", p, max_abs_err=e,
            max_row_rel_err=rel,
            shape=f"{arch}: B=1 C={C} q_len={qlen} ctx={c_end} H={H} K={K} "
                  f"hd={hd} {opts}",
            **timed(timer, lambda: pa.paged_prefill_attention(
                        q, kp, vp, bt, ctxt, ql, **opts),
                    lambda: paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql,
                                                      **opts)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_chk, 4.0 * pairs * H * hd))))

        # packed: T = 512 rows of 4 sequences, with the fused KV write
        T, q_lens, pctx = 512, [200, 96, 150, 40], FAMILY_PACKED[name]
        inp = ragged_inputs(torch, gen, H, K, hd, bs, T, q_lens, pctx)
        r = [ragged_checks(torch, inp, "bf16", f"ragged {name} {o}", o)
             for o in variants][0]
        qr, seqs, seq = inp["q"], inp["seqs"], inp["seq"]
        k1, v1, k2, v2, kn, vn = (r[k] for k in ("k1", "v1", "k2", "v2",
                                                  "kn", "vn"))

        def plain_fused():
            from repro_torch.models.attention import update_paged_cache_ragged
            update_paged_cache_ragged(k2, kn[None], *seqs, seq)
            update_paged_cache_ragged(v2, vn[None], *seqs, seq)
            return ragged_chunk_attention_xla(qr, k2, v2, *seqs, seq, **opts)

        pairs = sum(visible_keys(c - n + i, window)
                    for n, c in zip(q_lens, pctx) for i in range(n))
        span = sum(c - (0 if window is None else max(0, c - n - window + 1))
                   for n, c in zip(q_lens, pctx))
        qb, rb, meta = 2 * qr.numel() * 2, kv_row_bytes("bf16", K, hd), \
            seqs[0].numel() * 4 + 3 * len(q_lens) * 4
        b_write = qb + 2 * span * rb + 2 * sum(q_lens) * rb + meta
        family_row(
            rows, "ragged_paged_prefill_attention", p, max_abs_err=r["e"],
            max_row_rel_err=r["rel"],
            shape=f"{arch}: T={T} S={len(q_lens)} q_lens={q_lens} "
                  f"ctx={pctx} H={H} K={K} hd={hd} {opts}; fused KV write",
            **timed(timer, lambda: pa.ragged_paged_prefill_attention(
                        qr, k1, v1, *seqs, k_new=kn, v_new=vn, **opts),
                    plain_fused),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(b_write, 4.0 * pairs * H * hd))))
        print(f"[kernels] {name} (H={H} K={K} G={H // K} hd={hd}, "
              f"{opts or 'causal'}): decode == chunk(C=1), packed S=1 == "
              "chunk, packed == unpacked, fused write == scatter (bit for "
              f"bit); within {TOL} of plain", flush=True)
        del inp, r, k1, v1, k2, v2

        # the flash forward at the member's shapes
        for case, (Bf, S) in enumerate(FAMILY_FLASH[name]):
            d = check_family_flash(torch, timer, gen, arch, H, K, hd,
                                   variants, Bf, S, F, fa, ref,
                                   dense_attention)
            if case == 0:
                family_row(rows, "flash_attention", p, **d)
            else:
                rows["flash_attention"].setdefault(
                    p + "serving_shapes", []).append(d)
            print(f"[kernels] flash {name} at B={Bf} S={S}: {d['ms']:.4f} ms "
                  f"({d['tflops']:.0f} TFLOP/s), device "
                  f"{d['device_ms']:.4f}, SDPA "
                  f"{d.get('library_ms') or d.get('sdpa_causal_no_cap_ms')}"
                  f" ms{' (causal, no cap: a yardstick)' if opts else ''}; o "
                  f"max row rel err {d['max_row_rel_err']:.3g}, lse "
                  f"{d['lse_max_abs_err']:.3g}; two launches bit-equal",
                  flush=True)

        # the gather at the member's embedding table
        c = get_config(arch)
        V, d = c.padded_vocab_size, c.d_model
        table = torch.randn((V, d), generator=gen, device=DEV).bfloat16()
        for n in (8, 256):
            i = torch.randint(0, V, (n,), generator=gen, device=DEV,
                              dtype=torch.int32)
            check(torch.equal(emb.gather(table, i), emb.gather_plain(table,
                                                                     i)),
                  f"gather != table[ids] at {arch} ({V}x{d}), {n} ids")
        family_row(
            rows, "gather", p, max_abs_err=0.0, max_row_rel_err=0.0,
            shape=f"{arch}: table {V}x{d} bf16 (rows of {2 * d} bytes), "
                  "256 ids",
            ms=timer(lambda: emb.gather(table, i)),
            device_ms=timer.device(lambda: emb.gather(table, i)),
            plain_ms=timer(lambda: emb.gather_plain(table, i)),
            library_ms=timer(lambda: torch.index_select(table, 0, i)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(2 * 256 * d * 2 + 256 * 4, 0.0))))
        print(f"[kernels] gather {name} ({V}x{d}): == table[ids]; 256 ids "
              f"{rows['gather'][p + 'ms']:.4f} ms, index_select "
              f"{rows['gather'][p + 'library_ms']:.4f}", flush=True)
        del table
        torch.cuda.empty_cache()


def check_kernels(torch, timer):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    rows = {}
    check_paged(torch, timer, gen, rows)
    check_paged_edges(torch, gen)
    mma_zero_rows_probe(torch, gen)
    check_ragged(torch, timer, gen, rows)
    check_gather(torch, timer, gen, rows)
    check_ssd(torch, timer, gen, rows)
    check_flash(torch, timer, gen, rows)
    check_sampled_softmax(torch, timer, gen, rows)
    check_family(torch, timer, gen, rows)
    for name, r in rows.items():
        extra = ""
        if "no_write_ms" in r:
            extra = (f" no_write: kernel_ms={r['no_write_ms']:.4f} "
                     f"plain_ms={r['no_write_plain_ms']:.4f} "
                     f"bound_ms={r['no_write_bound_ms']:.4f} "
                     f"max_row_rel_err={r['no_write_max_row_rel_err']:.3g}")
        print(f"[kernels] {name}: {r['shape']}: kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err']:.3g} "
              f"max_row_rel_err={r['max_row_rel_err']:.3g}{extra}",
              flush=True)
        print(f"[kernels] {name}: {json.dumps(r)}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------


def reset_launches(counters) -> None:
    for fn in counters:
        if isinstance(fn.launches, dict):
            fn.launches.clear()
        else:
            fn.launches = 0


def summary_name(kernel: str, key: str) -> str:
    """Summary name of a (wrapper, variant) launch key; variant "" for a
    wrapper that keeps one count."""
    return variant(kernel, key) if key else kernel


def read_launches(counters) -> dict:
    """{summary name: launches since the last reset}."""
    out = {}
    for fn in counters:
        if isinstance(fn.launches, dict):
            for pool, n in fn.launches.items():
                out[variant(fn.__name__, pool)] = n
        else:
            out[fn.__name__] = fn.launches
    return out


def run_launches(counters, eng) -> tuple[dict, dict]:
    """A serving run's launches, replay-aware: the counters' own since the
    last reset (eager steps, or a graph's warm-up and capture) plus, per
    graph, replays x the launches its capture recorded. Returns (total,
    the replays' part) by summary name."""
    total = read_launches(counters)
    replayed = {}
    if eng.graphs is not None:
        for (kernel, key), n in eng.graphs.run_launches().items():
            name = summary_name(kernel, key)
            replayed[name] = n
            total[name] = total.get(name, 0) + n
    return total, replayed


# ---------------------------------------------------------------------------
# phases 3-5: serve glm4_9b, mamba2_370m and zamba2_2p7b at full size
# ---------------------------------------------------------------------------


def weight_bytes(eng) -> int:
    """Bytes one decode step must read at least: every parameter once and
    the runner's fp32 copy of the logits table."""
    n = sum(t.numel() * t.element_size() for t in leaves(eng.params))
    return n + eng.runner.head.numel() * eng.runner.head.element_size()


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def request_mode(sp) -> str:
    """The sampling mode a step with this request alone runs in."""
    if sp.needs_pipeline:
        return "full"
    return "plain" if sp.temperature > 0 else "greedy"


def serve(torch, counters, eng, reqs, max_new, expect, modes=("greedy",),
          exact_len=True):
    """One instrumented ``eng.run``: launch counts zeroed before and read
    after, replay-aware (the kernels named in ``expect`` must have
    launched, and on a graph engine launched in replays); per step its
    shape and sampling mode, its wall time and the device span of its
    body (CUDA events around the replay, or around the eager body); finite
    logits (read from the body's outputs after the run); tokens in range
    (every request ``max_new`` of them unless ``exact_len`` is off: stop
    sequences and EOS retire early); the most chunks any step carried.
    The graphs of ``modes`` are captured before the run, as at a server's
    start-up, each timed. Returns (the run's measurements, its tokens)."""
    cfg = eng.cfg
    steps, finite, widest, last = [], [], [0], [None]
    run_step, forward = eng.step, eng._forward
    schedule = eng.sched.schedule

    def timed_forward(has_chunk, mode="greedy"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward(has_chunk, mode)
        end.record()
        logits = out["logits"]
        finite.append(torch.isfinite(logits[:, :cfg.vocab_size]).all())
        last[0] = (has_chunk, mode, start, end)
        return out

    def timed_step():
        last[0] = None
        t = time.monotonic()
        out = run_step()
        if last[0] is not None:
            steps.append((*last[0], time.monotonic() - t))
        return out

    chunks = []

    def counted_schedule():
        plan = schedule()
        widest[0] = max(widest[0], len(plan.chunks))
        chunks.extend((r.num_computed, n, r.context_len)
                      for _, r, n in plan.chunks)
        return plan

    eng.step, eng._forward = timed_step, timed_forward
    eng.sched.schedule = counted_schedule
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counters)
    capture_by_mode, pool_by_mode = {}, {}
    for mode in modes:             # a server's start-up, outside the run
        t = time.monotonic()
        eng.capture_graphs(mode=mode)
        torch.cuda.synchronize()
        capture_by_mode[mode] = time.monotonic() - t
        if eng.graphs is not None:
            pool_by_mode[mode] = eng.graphs.pool_bytes() / 2 ** 20
    capture_s = sum(capture_by_mode.values())
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    launches, replayed = run_launches(counters, eng)
    s = eng.stats
    for r in reqs:
        o = outs[r.rid]
        check(len(o) == max_new or (not exact_len and 1 <= len(o) <= max_new),
              f"request {r.rid}: {len(o)} tokens, not {max_new}")
        check(bool(((o >= 0) & (o < cfg.vocab_size)).all()),
              f"request {r.rid}: token out of range")
    check(bool(torch.stack(finite).all()), "non-finite logits")
    q = eng.sched.chunk_quantum
    check(all(lo % q == 0 and (n % q == 0 or lo + n == total)
              for lo, n, total in chunks),
          f"a non-final chunk is not a multiple of the quantum {q}")
    graphs = eng.graphs is not None
    for name in expect:
        check(launches.get(name, 0) > 0,
              f"kernel {name} never launched on the main path")
        check(not graphs or replayed.get(name, 0) > 0,
              f"kernel {name} is in no replayed graph")
    if graphs:
        # one graph per (shape, mode) captured; steps replay only the
        # modes that the requests need (greedy runs: the greedy pair)
        used = {m for _, m in eng.graphs.graphs}
        need = {request_mode(r.sampling) for r in reqs}
        replayed_modes = {m for (_, m), n in eng.graphs.replays.items() if n}
        check(s["graph_captures"] == len(eng.graphs.graphs)
              <= 2 * len(used) and used <= set(modes) | need
              and replayed_modes <= need
              and sum(s["graph_replays"].values()) == s["steps"],
              f"graphs: {s['graph_captures']} captures of modes "
              f"{sorted(used)} (requests need {sorted(need)}), replays "
              f"{s['graph_replays']} over {s['steps']} steps")
    # the means leave each (shape, mode)'s first step out (eager: lazy
    # set-up; graphs: a capture at that step for a mode not captured up
    # front)
    by_key = {}
    for has_chunk, mode, start, end, wall in steps:
        by_key.setdefault((has_chunk, mode), []).append(
            (wall, start.elapsed_time(end)))
    by_shape = {h: [x for (hc, _), v in by_key.items() if hc == h
                    for x in v[1:]] for h in (True, False)}
    first = [w[0] for w in by_key.values() if w]

    def mean(xs):
        return sum(xs) / max(len(xs), 1)

    def name(key):
        return ("chunk" if key[0] else "decode") + "/" + key[1]

    by_mode = {name(k): {"steps": len(v), "step_ms_mean": 1e3 * mean(
        [w for w, _ in v[1:]]), "device_ms_mean": mean([d for _, d in v[1:]])}
        for k, v in sorted(by_key.items())}
    device_ms = sum(start.elapsed_time(end) for _, _, start, end, _ in steps)
    lat = [s["latency"][r.rid] for r in reqs]
    ttft = [x["first_token_wall"] - x["arrival_wall"] for x in lat]
    gap = [(x["done_wall"] - x["first_token_wall"]) / max(max_new - 1, 1)
           for x in lat]
    res = {"cuda_graphs": graphs, "kv_dtype": s["kv_dtype"],
           "prefill_pack": eng.prefill_pack,
           "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
           "token_gap_s_median": statistics.median(gap),
           "token_gap_s_max": max(gap),
           "tok_s": s["tok_s"], "wall_s": s["wall_s"], "steps": s["steps"],
           "tokens": s["tokens"],
           "capture_s": capture_s,
           "first_step_s": [w for w, _ in first],
           "chunk_step_ms_mean": 1e3 * mean([w for w, _ in by_shape[True]]),
           "decode_step_ms_mean": 1e3 * mean([w for w, _ in
                                              by_shape[False]]),
           "chunk_body_device_ms_mean": mean([d for _, d in by_shape[True]]),
           "decode_body_device_ms_mean": mean([d for _, d in
                                               by_shape[False]]),
           "body_device_ms": device_ms,
           "busy_share_events": device_ms / max(1e3 * s["wall_s"], 1e-9),
           "chunk_steps": sum(len(v) for k, v in by_key.items() if k[0]),
           "decode_steps": sum(len(v) for k, v in by_key.items()
                               if not k[0]),
           "by_mode": by_mode, "capture_s_by_mode": capture_by_mode,
           "graph_pool_mib_after_capture": pool_by_mode,
           "most_chunks_in_a_step": widest[0],
           "cache_hit_tokens": s["cache_hit_tokens"],
           "prefill_chunks": s["prefill_chunks"],
           "kv_cache_mib": s["kv_cache_mib"],
           "slot_state_mib": s["slot_state_mib"],
           "quantum_dropped_tokens": s["quantum_dropped_tokens"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "graph_captures": s["graph_captures"],
           "graph_replays": dict(s["graph_replays"]),
           "graph_pool_mib": (eng.graphs.pool_bytes() / 2 ** 20 if graphs
                              else 0.0),
           "decode_floor_ms": 1e3 * weight_bytes(eng) / HBM_BYTES_PER_S,
           "launches": launches, "replayed_launches": replayed}
    return res, {r.rid: outs[r.rid].tolist() for r in reqs}


def serve_ab(torch, counters, card, label, make_engine, make_reqs, max_new,
             expect):
    """Phases 3-5's A/B: the same requests through a graph engine (the
    card's default) and an eager one (``cuda_graphs=False``), same
    weights; greedy tokens byte-identical. Returns (graph run, eager
    run, the greedy tokens in request order)."""
    runs = {}
    toks = {}
    for graphs in (True, False):
        eng = make_engine(graphs)
        check((eng.graphs is not None) == graphs,
              f"{label}: cuda_graphs={graphs} not honoured")
        runs[graphs], toks[graphs] = serve(torch, counters, eng,
                                           make_reqs(), max_new, expect)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    g, e = runs[True], runs[False]
    check(list(toks[True].values()) == list(toks[False].values()),
          f"{label}: graph and eager greedy tokens differ")
    # the same kernels run in both: the graphs' device time over the eager
    # run's wall is the eager run's busy share (its events span the host's
    # launch gaps too)
    e["busy_share_from_graph_device_ms"] = g["body_device_ms"] / max(
        1e3 * e["wall_s"], 1e-9)
    print(f"[serve-ab] {card}: {label}: tokens byte-identical; graphs "
          f"{g['tok_s']} tok/s vs eager {e['tok_s']}; decode step "
          f"{g['decode_step_ms_mean']:.2f} vs {e['decode_step_ms_mean']:.2f}"
          f" ms (body on the device {g['decode_body_device_ms_mean']:.2f} vs "
          f"{e['decode_body_device_ms_mean']:.2f}; bytes floor "
          f"{g['decode_floor_ms']:.2f}); chunk step "
          f"{g['chunk_step_ms_mean']:.2f} vs {e['chunk_step_ms_mean']:.2f} "
          f"ms; busy share by events {g['busy_share_events']:.3f} vs "
          f"{e['busy_share_from_graph_device_ms']:.3f} (the graphs' "
          f"device ms over the eager wall); TTFT median "
          f"{g['ttft_s_median']:.3f} vs {e['ttft_s_median']:.3f} s; token "
          f"gap median {1e3 * g['token_gap_s_median']:.2f} vs "
          f"{1e3 * e['token_gap_s_median']:.2f} ms; peak "
          f"{g['peak_mem_gib']:.2f} vs {e['peak_mem_gib']:.2f} GiB; graph "
          f"pool {g['graph_pool_mib']:.1f} MiB, both captures "
          f"{g['capture_s']:.2f} s", flush=True)
    return g, e, list(toks[True].values())


def serve_full(torch, counters, card):
    """Phase 3: bf16 pools, one chunk per step, on graphs, then the same
    run eager (A/B). Returns (the graph run's measurements with the eager
    run's under "eager", the parameters, kept for phase 4)."""
    from repro_torch.config import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serving import InferenceEngine, Request

    cfg = get_config("glm4_9b")
    t0 = time.monotonic()
    params = init_model(cfg, 0, DEV)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    prompts = phase3_prompts(cfg)

    def make_engine(graphs):
        eng = InferenceEngine(cfg, device=DEV, params=params, max_batch=8,
                              block_size=16, max_len=1024,
                              max_num_batched_tokens=8 + 256, seed=0,
                              cuda_graphs=graphs)
        check(eng.chunk_width == 256, f"chunk width {eng.chunk_width}")
        return eng

    res, eager, _ = serve_ab(
        torch, counters, card, "glm4_9b bf16 pack 1", make_engine,
        lambda: [Request(p.copy(), max_new=32) for p in prompts], 32,
        ("paged_attention", "paged_prefill_attention", "gather"))
    for r in (res, eager):
        check(r["cache_hit_tokens"] > 0, "no prefix-cache hits")
        check(r["prefill_chunks"] > len(prompts), "no prompt took two chunks")
    res.update(params=cfg.param_count(), init_s=init_s, eager=eager)
    print(f"[serve] {card}: glm4_9b full width, 40 layers "
          f"({res['params'] / 1e9:.2f} B params), bf16 pools, CUDA graphs: "
          f"{res['tok_s']} tok/s, decode step "
          f"{res['decode_step_ms_mean']:.2f} ms, chunk step "
          f"{res['chunk_step_ms_mean']:.2f} ms: {json.dumps(res)}",
          flush=True)
    return res, params


def packed_requests(cfg, n, max_new):
    """Phase 4's requests: prompt lengths drawn from [96, 480] (seed 0),
    the first 8 starting with one shared 128-token prefix."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    lens = rng.integers(96, 481, 16)
    prefix = rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
    reqs = []
    for i, n_tok in enumerate(lens[:n]):
        p = rng.integers(0, cfg.vocab_size, int(n_tok)).astype(np.int32)
        if i < 8:
            k = min(128, len(p))
            p[:k] = prefix[:k]
        reqs.append(Request(p, max_new=max_new))
    return reqs


def serve_packed(torch, counters, card, params):
    """Phase 4: int8 pools with prefill_pack 4 (16 requests; on graphs,
    then eager, A/B), then the other pool/pack pairs at full width (8
    requests, 4 new tokens), on graphs."""
    from repro_torch.config import get_config
    from repro_torch.models.quant import KV_DTYPES
    from repro_torch.serving import InferenceEngine

    cfg = get_config("glm4_9b")
    runs = [(4, "int8", 16, 16), (4, "bf16", 8, 4), (4, "fp8", 8, 4),
            (1, "int8", 8, 4), (1, "fp8", 8, 4)]
    results = []
    for i, (pack, kv, n, max_new) in enumerate(runs):
        def make_engine(graphs, pack=pack, kv=kv):
            eng = InferenceEngine(cfg, device=DEV, params=params,
                                  max_batch=8, block_size=16, max_len=1024,
                                  max_num_batched_tokens=8 + 512, seed=0,
                                  prefill_pack=pack, kv_dtype=kv,
                                  cuda_graphs=graphs)
            check(eng.chunk_width == 512 and eng.prefill_pack == pack,
                  f"chunk width {eng.chunk_width}, pack {eng.prefill_pack}")
            check(eng.cache["k"].dtype == KV_DTYPES[kv],
                  f"pools are {eng.cache['k'].dtype}, not {kv}")
            return eng

        def make_reqs(n=n, max_new=max_new):
            return packed_requests(cfg, n, max_new)

        prefill = ("ragged_paged_prefill_attention" if pack > 1
                   else "paged_prefill_attention")
        expect = (variant(prefill, kv), variant("paged_attention", kv),
                  "gather")
        if i == 0:
            res, eager, _ = serve_ab(
                torch, counters, card, f"glm4_9b {kv} pack {pack}",
                make_engine, make_reqs, max_new, expect)
            res["eager"] = eager
        else:
            eng = make_engine(True)
            res, _ = serve(torch, counters, eng, make_reqs(), max_new,
                           expect)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        check(res["cache_hit_tokens"] > 0, f"({pack}, {kv}): no prefix hits")
        if pack > 1:
            check(res["most_chunks_in_a_step"] >= 2,
                  f"({pack}, {kv}): no step carried two chunks")
        res["requests"] = n
        print(f"[serve-packed] {card}: glm4_9b full width, prefill_pack "
              f"{pack}, {kv} pools, {n} requests, CUDA graphs: "
              f"{res['tok_s']} tok/s, decode step "
              f"{res['decode_step_ms_mean']:.2f} ms, chunk step "
              f"{res['chunk_step_ms_mean']:.2f} ms, TTFT median "
              f"{res['ttft_s_median']:.3f} s max {res['ttft_s_max']:.3f} s, "
              f"token gap median {1e3 * res['token_gap_s_median']:.2f} ms "
              f"max {1e3 * res['token_gap_s_max']:.2f} ms, peak "
              f"{res['peak_mem_gib']:.2f} GiB: {json.dumps(res)}",
              flush=True)
        results.append(res)
    return results


# ---------------------------------------------------------------------------
# phase 9: the sampling surface and speculative decoding at glm4's size
# ---------------------------------------------------------------------------


def check_streams(torch, V):
    """Phase 9a: jax's threefry bits for 64 (seed, rid, counter, tag) keys
    over V words, card against CPU, bit for bit; the Gumbel noise within
    2 ulp of max(1, |g|). The first words are printed for a check against
    ``jax.random.bits`` off the card. Then the draw's own device time:
    ``sample_tokens`` and ``sample_tokens_full`` over (9, V) rows, each
    captured alone in a CUDA graph, against an argmax, by events around
    replays."""
    import numpy as np
    from repro_torch.serving import prng
    from repro_torch.serving.sampling import (SP_KEYS, base_key,
                                              sample_tokens,
                                              sample_tokens_full)

    g = np.random.default_rng(3)
    seeds = torch.tensor(g.integers(-2 ** 31, 2 ** 31, 64), dtype=torch.int32)
    rids = torch.tensor(g.integers(0, 2 ** 20, 64))
    cnts = torch.tensor(g.integers(0, 2 ** 20, 64))
    tags = torch.tensor(g.integers(0, 4, 64))          # 0: the plain stream
    base = base_key(seeds, rids, cnts)
    keys = torch.where((tags > 0)[:, None], prng.fold_in(base, tags), base)
    bits = {d: prng.random_bits(keys.to(d), V).cpu() for d in ("cpu", DEV)}
    check(torch.equal(bits["cpu"], bits[DEV]),
          "threefry bits differ between the card and the CPU")
    gum = {d: prng.gumbel(keys.to(d), V).cpu().numpy() for d in ("cpu", DEV)}
    # ulps of max(1, |g|): near g = 0, -log(-log(u)) cancels, and one ulp
    # of the inner log (near 1) is many ulps of the result
    ulps = np.abs(gum[DEV] - gum["cpu"]) / np.spacing(
        np.maximum(np.abs(gum["cpu"]), np.float32(1)))
    check(float(ulps.max()) <= 2, f"Gumbel noise: card vs CPU "
          f"{float(ulps.max())} ulp of max(1, |g|)")
    for i in range(3):
        print(f"[streams] seed {int(seeds[i])} rid {int(rids[i])} counter "
              f"{int(cnts[i])} tag {int(tags[i])}: bits[:4] "
              f"{[hex(int(x)) for x in bits[DEV][i, :4]]}", flush=True)
    # the draw alone, as the step graph runs it
    N = 9
    gen = torch.Generator(device=DEV).manual_seed(0)
    logits = torch.randn((N, V), generator=gen, device=DEV) * 3
    a = {"temps": torch.full((N,), 0.8, device=DEV),
         "top_ks": torch.full((N,), 50, dtype=torch.int32, device=DEV),
         "seeds": seeds[:N].to(DEV), "rids": rids[:N].to(DEV),
         "counters": cnts[:N].to(DEV),
         "top_ps": torch.full((N,), 0.9, device=DEV),
         "min_ps": torch.full((N,), 0.05, device=DEV),
         "rep_pens": torch.full((N,), 1.2, device=DEV),
         "pres_pens": torch.full((N,), 0.3, device=DEV),
         "freq_pens": torch.full((N,), 0.2, device=DEV),
         "pmask": torch.rand((N, V), generator=gen, device=DEV) < 0.01,
         "ocounts": (torch.rand((N, V), generator=gen, device=DEV)
                     < 0.001).int()}
    plain = ("temps", "top_ks", "seeds", "rids", "counters")
    fns = {"argmax": lambda: torch.argmax(logits, -1),
           "plain": lambda: sample_tokens(logits, *(a[k] for k in plain)),
           "full": lambda: sample_tokens_full(
               logits, {k: a[k] for k in SP_KEYS}, max_logprobs=8)}
    ms = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        ms[name] = graph_replay_ms(torch, graph)
        del graph
    print(f"[streams] card and CPU bits equal for 64 keys x {V}; Gumbel "
          f"within {float(ulps.max()):.0f} ulp of max(1, |g|); draw over "
          f"({N}, {V}) rows on a graph: plain {ms['plain']:.4f} ms, full "
          f"{ms['full']:.4f} "
          f"ms, an argmax {ms['argmax']:.4f} ms", flush=True)
    return {"bits_equal": True, "gumbel_max_ulp": float(ulps.max()),
            "draw_ms": ms}


def graph_replay_ms(torch, graph, iters=50):
    """Mean device time of a replay of ``graph`` by CUDA events."""
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def near_tie_or_same(torch, params, cfg, prompt, ours, ref, limit=TOL,
                     margins=None) -> bool:
    """Equal greedy streams (True), or a first difference whose top-2
    margin (the card's logits after the common prefix, one monolithic
    chunk) is below ``limit``, the bf16 tolerance by default (False);
    anything else fails. ``margins`` collects (step, margin, limit)."""
    import numpy as np
    if ours == ref:
        return True
    i = next(j for j, (x, y) in enumerate(zip(ours, ref)) if x != y)
    lg = last_logits(torch, params, cfg,
                     np.concatenate([prompt, np.asarray(ours[:i], np.int32)]),
                     "bf16", device=DEV)
    top = torch.topk(lg, 2)
    margin = float(top.values[0] - top.values[1])
    if margins is not None:
        margins.append((i, margin, limit))
    check(margin < limit and {ours[i], ref[i]} == set(top.indices.tolist()),
          f"greedy streams differ at step {i} with top-2 margin {margin} "
          f"(limit {limit})")
    return False


def serve_sampling(torch, counters, card, params):
    """Phase 9 at glm4_9b's full width and depth (the phase-3 weights),
    on CUDA graphs: (a) the streams, card against CPU; (b) mixed sampling:
    a greedy / temperature-top-k batch alone and again beside one
    logprobs request (full graphs): byte-identical tokens; then eight
    requests (greedy; t 0.8 top-k 50; top-p 0.9 min-p 0.05; penalties;
    logprobs 5; a stop sequence from the first greedy run's output;
    min_new over an EOS; top-k + top-p + logprobs) on graphs and eager:
    tokens and logprobs byte-identical, the stop fires where the greedy
    stream completes it; (c) speculative decoding, k = 2: a self-draft
    sharing the weights, a fresh draft of 4 layers, the self-draft at
    t = 0.8; greedy runs equal the plain greedy graph run (near-tie
    rule; bitwise or not is reported). Returns the runs' measurements."""
    import dataclasses
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serving import InferenceEngine, Request, SamplingParams

    cfg = get_config("glm4_9b")
    streams = check_streams(torch, cfg.padded_vocab_size)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(160, 321, 8)]
    max_new, modes = 24, ("greedy", "plain", "full")
    expect = ("paged_attention", "paged_prefill_attention", "gather")
    base_kw = dict(device=DEV, params=params, max_batch=8, block_size=16,
                   max_len=1024, seed=0)
    runs = []

    def run(label, specs, graphs=True, spec=None, eos=None, min_new=None):
        kw = dict(base_kw, max_num_batched_tokens=8 + 256)
        if spec is not None:
            kw.update(spec, max_num_batched_tokens=8 * 3 + 256)
        eng = InferenceEngine(cfg, cuda_graphs=graphs, **kw)
        probe = VerifyProbe(eng) if spec is not None else None
        reqs = [Request(prompts[i].copy(), max_new=max_new, sampling=sp,
                        rid=900 + j, eos_id=(eos or {}).get(j),
                        min_new=(min_new or {}).get(j, 0))
                for j, (i, sp) in enumerate(specs)]
        lps = []
        eng.on_token = lambda r, t, lp: lps.append((r.rid, t, lp))
        try:
            res, toks = serve(torch, counters, eng, reqs, max_new, expect,
                              modes=modes if graphs else (),
                              exact_len=eos is None)
        finally:
            if probe is not None:
                probe.close()
        if probe is not None:
            res["verify_launches"], res["verify_replayed_launches"] = \
                probe.launches(cfg.num_layers, res["steps"])
        res.update(label=label, stats={k: eng.stats[k] for k in (
            "full_sampling_steps", "stop_hits", "spec_decodes",
            "spec_emitted", "graph_replays")},
            mean_accept_len=eng.mean_accept_len)
        stop_hit = {r.rid: r.stop_hit for r in reqs}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        modes_line = ", ".join(
            f"{k} {v['step_ms_mean']:.2f} ms (device "
            f"{v['device_ms_mean']:.2f}, {v['steps']} steps)"
            for k, v in res["by_mode"].items())
        cap = {k: round(v, 3) for k, v in res["capture_s_by_mode"].items()}
        pool = {k: round(v, 1)
                for k, v in res["graph_pool_mib_after_capture"].items()}
        print(f"[serve-sampling] {card}: {label}: {res['tok_s']} tok/s; "
              f"steps by (shape/mode): {modes_line}; capture s {cap}"
              f"; graph pool MiB after each capture {pool}"
              f"; mean_accept_len {res['mean_accept_len']:.3f}; peak "
              f"{res['peak_mem_gib']:.2f} GiB; {json.dumps(res['stats'])}",
              flush=True)
        runs.append(res)
        return res, [toks[900 + j] for j in range(len(specs))], lps, \
            stop_hit

    greedy = SamplingParams()
    tk = SamplingParams(temperature=0.8, top_k=50, seed=1)
    base = [(0, greedy), (1, tk), (2, SamplingParams(temperature=1.0,
                                                     seed=2)), (3, greedy)]
    _, alone, _, _ = run("greedy + temperature/top-k", base)
    forced, beside, _, _ = run("the same beside a logprobs request",
                               base + [(4, SamplingParams(logprobs=1))])
    check(forced["stats"]["full_sampling_steps"] > 0, "no full step ran")
    check(beside[:4] == alone, "tokens of plain rows in full steps differ "
          "from the plain graphs'")
    out0 = alone[0]
    stop = tuple(out0[5:7])
    mixed = [(0, greedy), (1, tk),
             (2, SamplingParams(temperature=0.9, top_p=0.9, min_p=0.05,
                                seed=3)),
             (3, SamplingParams(temperature=0.7, repetition_penalty=1.2,
                                presence_penalty=0.3, frequency_penalty=0.2,
                                seed=4)),
             (4, SamplingParams(temperature=0.6, logprobs=5, seed=5)),
             (0, SamplingParams(stop=(stop,))),
             (0, greedy),
             (5, SamplingParams(temperature=1.0, top_k=20, top_p=0.95,
                                logprobs=3, seed=7))]
    eos, min_new = {6: out0[2]}, {6: 8}
    res_g, toks_g, lps_g, hits = run("mixed sampling, graphs", mixed,
                                     eos=eos, min_new=min_new)
    res_e, toks_e, lps_e, _ = run("mixed sampling, eager", mixed,
                                  graphs=False, eos=eos, min_new=min_new)
    check(toks_g == toks_e, "mixed sampling: graph and eager tokens differ")
    check(lps_g == lps_e, "mixed sampling: graph and eager logprobs differ")
    g0 = toks_g[0]
    first = next((i for i in range(1, len(g0))
                  if tuple(g0[i - 1:i + 1]) == stop), None)
    check(first is not None and toks_g[5] == g0[:first + 1] and hits[905],
          f"the stop {stop} did not retire request 905 where the greedy "
          f"stream completes it: {toks_g[5]} vs {g0}")
    m = toks_g[6]
    check(m == g0[:len(m)] and len(m) >= 8
          and (len(m) == max_new or m[-1] == out0[2]),
          f"min_new: request 906 gave {m}")
    res_g["eager"] = res_e
    sampling = {"streams": streams, "stop": list(stop),
                "stop_fired_at": first, "min_new_len": len(m)}

    # (c) speculative decoding, k = 2
    plain_res, plain, _, _ = run("plain greedy (8 requests)",
                                 [(i, greedy) for i in range(8)])
    spec_runs = {}
    draft_cfg = dataclasses.replace(cfg, num_layers=4)
    for label, spec, sp in (
            ("self-draft, shared weights", dict(draft_cfg=cfg,
                                                draft_params=params), greedy),
            ("fresh glm4_9b draft, 4 of 40 layers",
             dict(draft_cfg=draft_cfg,
                  draft_params=init_model(draft_cfg, 1, DEV)), greedy),
            ("self-draft, t = 0.8", dict(draft_cfg=cfg, draft_params=params),
             SamplingParams(temperature=0.8, seed=11))):
        spec["num_speculative_tokens"] = 2
        res, toks, _, _ = run(f"speculative k=2, {label}",
                              [(i, sp) for i in range(8)], spec=spec)
        spec.clear()
        check(res["stats"]["spec_decodes"] > 0, f"{label}: no verify step")
        if sp is greedy:
            bitwise = [near_tie_or_same(torch, params, cfg, prompts[i], o, r)
                       for i, (o, r) in enumerate(zip(toks, plain))]
            res["bitwise_equal_to_plain"] = all(bitwise)
            res["requests_bitwise_equal"] = sum(bitwise)
        spec_runs[label] = res
        print(f"[serve-spec] {card}: {label}: mean_accept_len "
              f"{res['mean_accept_len']:.3f}, {res['tok_s']} tok/s (plain "
              f"greedy {plain_res['tok_s']}), spec decode step "
              f"{res['decode_step_ms_mean']:.2f} ms (device "
              f"{res['decode_body_device_ms_mean']:.2f}; plain greedy "
              f"{plain_res['decode_step_ms_mean']:.2f}), chunk step "
              f"{res['chunk_step_ms_mean']:.2f} ms, verify launches "
              f"{res['verify_launches']} ({res['verify_replayed_launches']}"
              f" in replays), peak "
              f"{res['peak_mem_gib']:.2f} GiB"
              + (f", greedy tokens equal plain greedy (near-tie rule), "
                 f"bitwise for {res['requests_bitwise_equal']}/8 requests"
                 if sp is greedy else ""), flush=True)
    sampling["speculative"] = {k: {n: v[n] for n in (
        "mean_accept_len", "tok_s", "decode_step_ms_mean",
        "decode_body_device_ms_mean", "chunk_step_ms_mean", "peak_mem_gib")}
        for k, v in spec_runs.items()}
    print(f"[serve-sampling] {card}: {json.dumps(sampling)}", flush=True)
    verify = {k: sum(r[k] for r in spec_runs.values())
              for k in ("verify_launches", "verify_replayed_launches")}
    return runs, verify


class VerifyProbe:
    """Counts the chunk kernel's launches inside a speculative engine's
    verify pass (``prefill_chunk_paged(all_logits=True)``, which only the
    verify calls), replay-aware: the counter's delta over every eager call
    (warm-ups, captures, eager steps) plus, per graph, its replays x the
    delta over the call that its capture recorded."""

    def __init__(self, eng):
        from repro_torch.models import transformer
        from repro_torch.serving.graphs import WARMUP_STEPS, launch_counts

        self.transformer, self.eng = transformer, eng
        self.fn = fn = transformer.prefill_chunk_paged
        self.calls, self.per_capture = [], {}

        def counted():
            return sum(n for (k, _), n in launch_counts().items()
                       if k == "paged_prefill_attention")

        def verify_counted(*args, **kw):
            if not kw.get("all_logits"):
                return fn(*args, **kw)
            n = counted()
            out = fn(*args, **kw)
            self.calls.append(counted() - n)
            return out

        transformer.prefill_chunk_paged = verify_counted
        graphs = eng.graphs
        if graphs is not None:
            capture = graphs.capture

            def capture_counted(key):
                n = len(self.calls)
                capture(key)
                check(len(self.calls) == n + WARMUP_STEPS + 1,
                      f"verify probe: {len(self.calls) - n} verify passes "
                      f"in the capture of {key}")
                self.per_capture[key] = self.calls[-1]

            graphs.capture = capture_counted

    def close(self):
        self.transformer.prefill_chunk_paged = self.fn

    def launches(self, layers: int, steps: int) -> tuple[int, int]:
        """The run's verify launches and the replays' part of them; checks
        one launch per target layer in every verify pass and one replayed
        verify per step."""
        replays = self.eng.graphs.replays if self.eng.graphs else {}
        check(all(n == layers for n in self.calls)
              and all(n == layers for n in self.per_capture.values()),
              f"verify passes launched {sorted(set(self.calls))} chunk "
              f"kernels (captures {self.per_capture}), not {layers}")
        replayed = sum(self.per_capture[k] * n for k, n in replays.items())
        check(replayed == steps * layers,
              f"verify launches in replays {replayed} != {steps} steps x "
              f"{layers} layers")
        return sum(self.calls) + replayed, replayed


def graph_edge_types(graph) -> dict:
    """{dependency type: edges} of a captured CUDA graph, read with
    libcuda's cuGraphGetEdges_v2 (type 0: full dependency, 1:
    programmatic, as a programmatic dependent launch is captured).
    ``graph`` must have been made with keep_graph=True."""
    import ctypes
    fn = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    cap = 1 << 16
    frm, to = (ctypes.c_void_p * cap)(), (ctypes.c_void_p * cap)()
    data = (ctypes.c_ubyte * (8 * cap))()       # CUgraphEdgeData: 8 bytes
    n = ctypes.c_size_t(cap)
    rc = fn(graph.raw_cuda_graph(), frm, to, data, ctypes.byref(n))
    check(rc == 0 and n.value < cap, f"cuGraphGetEdges_v2: error {rc}, "
          f"{n.value} edges")
    types = {}
    for i in range(n.value):
        t = data[8 * i + 2]                    # from_port, to_port, type
        types[t] = types.get(t, 0) + 1
    return types


def serve_ssm(torch, counters, card):
    """Phase 5: mamba2_370m (SSMRunner) and zamba2_2p7b (HybridRunner)
    at full width and depth, random bf16 weights from seed 0, max_batch 8,
    a 264-token budget (256-token chunks, the SSD chunk size). mamba2
    serves 8 requests of 512 tokens (32 new each), then 8 of 300-500
    tokens (16 new each: a 256-token chunk, then a final exempt one);
    zamba2 serves 8 of 512 tokens (16 new each). Each run on graphs, then
    eager (A/B). The ssd kernel launches once per mamba layer and chunk;
    the chunk graph's edges by type say whether its capture kept the
    scan's programmatic dependent launches."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serving import InferenceEngine, Request

    results = []
    runs = (("mamba2_370m", "512", 32), ("mamba2_370m", "300-500", 16),
            ("zamba2_2p7b", "512", 16))
    kw = dict(device=DEV, max_batch=8, block_size=16, max_len=1024,
              max_num_batched_tokens=8 + 256, seed=0)
    params = params_cfg = None
    for arch, lens, max_new in runs:
        cfg = get_config(arch)
        if params_cfg != cfg:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.monotonic()
            params, params_cfg = init_model(cfg, 0, DEV), cfg
            torch.cuda.synchronize()
            init_s = time.monotonic() - t0
        seen = {}

        def make_engine(graphs, cfg=cfg, seen=seen):
            eng = InferenceEngine(cfg, params=params, cuda_graphs=graphs,
                                  **kw)
            check(eng.chunk_width == 256 == eng.sched.chunk_quantum,
                  f"chunk width {eng.chunk_width}, quantum "
                  f"{eng.sched.chunk_quantum}")
            seen["runner"] = type(eng.runner).__name__
            if graphs:
                capture = eng.graphs.capture

                def inspected(key):
                    capture(key)
                    if key[0]:
                        seen["edges"] = graph_edge_types(
                            eng.graphs.graphs[key])
                eng.graphs.capture = inspected
            return eng

        rng = np.random.default_rng(0)
        n_tok = ([512] * 8 if lens == "512"
                 else rng.integers(300, 501, 8).tolist())
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in n_tok]
        expect = ["ssd", "gather"]
        if cfg.shared_attn_period:
            expect += ["paged_attention", "paged_prefill_attention"]
        res, eager, _ = serve_ab(
            torch, counters, card, f"{arch} prompts of {lens} tokens",
            make_engine,
            lambda: [Request(p.copy(), max_new=max_new) for p in prompts],
            max_new, expect)
        n_mamba = sum(k == "mamba" for k in cfg.layer_kinds())
        for r in (res, eager):
            check(r["prefill_chunks"] == 2 * len(prompts),
                  f"{arch}: {r['prefill_chunks']} chunks, not 2 per prompt")
        check(eager["launches"]["ssd"] == n_mamba * eager["prefill_chunks"],
              f"{arch} eager: ssd launched {eager['launches']['ssd']} "
              f"times, not {n_mamba} layers x {eager['prefill_chunks']} "
              "chunks")
        check(res["replayed_launches"]["ssd"]
              == n_mamba * res["prefill_chunks"],
              f"{arch}: ssd replayed {res['replayed_launches']['ssd']} "
              f"times, not {n_mamba} layers x {res['prefill_chunks']} chunks")
        res.update(arch=arch, prompt_tokens=lens, requests=len(prompts),
                   params=cfg.param_count(), init_s=init_s,
                   runner=seen["runner"], eager=eager,
                   chunk_graph_edges_by_type=seen["edges"])
        print(f"[serve-ssm] {card}: {arch} full width, {cfg.num_layers} "
              f"layers ({res['params'] / 1e9:.2f} B params), "
              f"{res['runner']}, prompts of {lens} tokens, CUDA graphs: "
              f"{res['tok_s']} tok/s, decode step "
              f"{res['decode_step_ms_mean']:.2f} ms, chunk step "
              f"{res['chunk_step_ms_mean']:.2f} ms, TTFT median "
              f"{res['ttft_s_median']:.3f} s, token gap median "
              f"{1e3 * res['token_gap_s_median']:.2f} ms, slot state "
              f"{res['slot_state_mib']} MiB, KV "
              f"{res['kv_cache_mib'] - res['slot_state_mib']:.3f} MiB, peak "
              f"{res['peak_mem_gib']:.2f} GiB, ssd launches "
              f"{res['launches']['ssd']} ({res['replayed_launches']['ssd']} "
              f"in replays); chunk graph edges by type (0 full, 1 "
              f"programmatic) {seen['edges']}: {json.dumps(res)}",
              flush=True)
        results.append(res)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 10: the rest of the dense family at full width
# ---------------------------------------------------------------------------

# phase 3's traffic (8 prompts of 512 tokens sharing a 256-token prefix,
# 32 new each) through each member; gemma2 also serves two 6000-token
# prompts, past its 4096-key window
LONG_PROMPT, LONG_REQUESTS = 6000, 2
def check_fits(torch, arch, cfg) -> None:
    """Fail, with the card's memory reading, if ``cfg``'s bf16 weights
    and the serving runner's fp32 head do not fit the free memory."""
    free, total = torch.cuda.mem_get_info()
    need = 2 * cfg.param_count() + 4 * cfg.padded_vocab_size * cfg.d_model
    check(need < free, f"{arch}: {cfg.num_layers} layers need "
          f"{need / 2 ** 30:.1f} GiB of bf16 weights and fp32 head; the "
          f"card has {free / 2 ** 30:.1f} GiB free of {total / 2 ** 30:.1f}")


# query rows per block of the fp32 reading's attention
FP32_ROWS = 512


def fp32_logits(torch, params, cfg, tokens, head):
    """The last position's logits (B, V_pad) of the same bf16 weights
    computed in fp32: the bf16 embedding's output cast up, each layer's
    weights cast up in turn (one layer's fp32 copy alive at a time),
    activations in fp32, attention by the plain ``dense_attention`` in fp32
    (FP32_ROWS query rows at a time), the fp32 head. Neither the flash nor
    a paged kernel takes part: an independent reading of the function both
    serving paths compute in bf16."""
    from repro_torch.models.attention import (attention_scale,
                                              dense_attention, project_kv,
                                              project_q)
    from repro_torch.models.embedding import decode_logits, embed
    from repro_torch.models.transformer import _layers, _rope

    def up(t):
        return ({n: up(v) for n, v in t.items()} if isinstance(t, dict)
                else t.float())

    B, S = tokens.shape
    x = embed(params["embed"]["table"], tokens, cfg).float()
    cos_sin = _rope(cfg, torch.arange(S, dtype=torch.int32,
                                      device=tokens.device)[None].expand(B, S))

    def attend(ap, h, pools, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        return torch.cat([dense_attention(
            q[:, r:r + FP32_ROWS], k[:, :r + FP32_ROWS],
            v[:, :r + FP32_ROWS], causal=True, window=window,
            cap=cfg.attn_logit_softcap, scale=attention_scale(cfg),
            q_offset=r) for r in range(0, S, FP32_ROWS)], dim=1)

    x = _layers({"layers": (up(lp) for lp in params["layers"]),
                 "final_norm": up(params["final_norm"])}, {}, cfg, x, attend)
    return decode_logits(x[:, -1:], head, cfg)


def static_vs_engine(torch, counters, params, cfg, prompts, max_new, ref,
                     label) -> dict:
    """The static path (``api.generate_static``: the flash kernel for the
    prefill, plain decode attention over dense caches) on the same
    prompts. Both paths' logits after each prompt (the static prefill's;
    the engine path's, one paged chunk) are held against the fp32 reading
    (``fp32_logits``): the static path may be at most twice as far from it
    as the engine path (a wrong flash prefill would be far from it; the
    two bf16 paths' rounding, amplified over the layers, is what both
    show). Its greedy tokens then equal the engine's ``ref`` tokens, or
    part at a near-tie: a top-2 margin below the sum of the two paths'
    measured distances from the fp32 reading (the largest gap those
    readings allow between them), or TOL if that is larger. Counts its
    flash launches. Returns the readings."""
    import numpy as np
    from repro_torch.models.api import generate_static
    from repro_torch.models.embedding import head_table
    from repro_torch.models.transformer import prefill_logits

    V = cfg.vocab_size
    head = head_table(params["embed"], cfg).float()
    tokens = torch.from_numpy(np.stack(prompts)).to(DEV)
    reset_launches(counters)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        out = generate_static(params, tokens, cfg, max_new, head=head)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches(counters)
    check(launches.get("flash_attention", 0) == cfg.num_layers,
          f"{label}: static prefill made {launches.get('flash_attention')} "
          f"flash launches, not {cfg.num_layers}")
    with torch.no_grad():
        static = prefill_logits(params, {"tokens": tokens}, cfg,
                                head)[1][:, :V]
        engine = torch.stack([last_logits(torch, params, cfg, p, "bf16",
                                          device=DEV) for p in prompts])
        t0 = time.monotonic()
        exact = fp32_logits(torch, params, cfg, tokens, head)[:, :V]
        torch.cuda.synchronize()
        fp32_s = time.monotonic() - t0
    del head
    e_static, e_engine = err(static, exact), err(engine, exact)
    delta = err(static, engine)
    std = float(exact.std())
    check(e_static <= 2 * e_engine,
          f"{label}: the static prefill's logits are {e_static:.4g} from "
          f"the fp32 reading, more than twice the engine path's "
          f"{e_engine:.4g}")
    limit = max(TOL, e_static + e_engine)
    margins = []
    same = [near_tie_or_same(torch, params, cfg, p, o.tolist(), r, limit,
                             margins)
            for p, o, r in zip(prompts, out.cpu(), ref)]
    print(f"[static] {label}: generate_static (prefill through the flash "
          f"kernel, {max_new - 1} decode steps) in {wall:.2f} s; logits "
          f"after the prompts: max abs distance from the fp32 reading "
          f"(std {std:.4g}, {fp32_s:.1f} s) static {e_static:.4g}, engine "
          f"{e_engine:.4g}; static vs engine {delta:.4g}; "
          f"{sum(same)}/{len(same)} requests token-identical to the engine, "
          f"the rest part at a near-tie: (step, top-2 margin, limit) "
          f"{margins}", flush=True)
    return {"wall_s": wall, "identical": sum(same), "requests": len(same),
            "margins": margins, "logit_delta": delta,
            "fp32_err_static": e_static, "fp32_err_engine": e_engine,
            "fp32_logit_std": std, "fp32_s": fp32_s, "launches": launches}


# the numbers of a serving run that phase 10's summary line carries
BRIEF = ("tok_s", "wall_s", "steps", "tokens", "decode_step_ms_mean",
         "decode_body_device_ms_mean", "chunk_step_ms_mean",
         "chunk_body_device_ms_mean", "busy_share_events",
         "busy_share_from_graph_device_ms", "ttft_s_median", "ttft_s_max",
         "token_gap_s_median", "token_gap_s_max", "peak_mem_gib",
         "graph_pool_mib", "capture_s", "decode_floor_ms", "kv_cache_mib",
         "cache_hit_tokens", "prefill_chunks", "most_chunks_in_a_step",
         "launches", "replayed_launches", "identical", "requests",
         "margins", "logit_delta", "fp32_err_static", "fp32_err_engine",
         "fp32_logit_std")


def brief(runs: dict) -> dict:
    return {k: {n: v for n, v in r.items() if n in BRIEF}
            for k, r in runs.items()}


def serve_family(torch, counters, card, rows) -> list:
    """Phase 10: qwen3_32b, gemma2_27b and starcoder2_3b at full width
    and depth (failing if one does not fit the card), random weights from
    seed 0, one at a time, each freed before the next: phase 3's traffic
    on CUDA graphs and eager (byte-identical tokens), the static path on
    the same prompts (logits held against an fp32 reading, tokens == the
    engine's up to a near-tie; ``static_vs_engine``), a prefill_pack 4 run
    of the same prompts (4 new tokens, the packed kernel; == the first 4
    of the pack-1 run up to a near-tie below twice the engine path's
    distance from the fp32 reading); gemma2 also serves two 6000-token prompts the same
    three ways. Each member's launches per kernel go into the kernels'
    rows (``<member>_launches``). Returns the runs."""
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serving import InferenceEngine, Request

    runs = []
    for name in ("qwen3", "gemma2", "starcoder2"):
        arch = FAMILY[name][0]
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        check_fits(torch, arch, cfg)
        t0 = time.monotonic()
        params = init_model(cfg, 0, DEV)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        rng = np.random.default_rng(0)
        prefix = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
        prompts = [np.concatenate(
            [prefix, rng.integers(0, cfg.vocab_size, 256).astype(np.int32)])
            for _ in range(8)]
        traffic = [("8x512", prompts, 8, 1024, 32)]
        if name == "gemma2":
            traffic.append(("2x6000", [
                rng.integers(0, cfg.vocab_size, LONG_PROMPT).astype(np.int32)
                for _ in range(LONG_REQUESTS)], LONG_REQUESTS,
                LONG_PROMPT + 48, 32))
        member = {"arch": arch, "layers": cfg.num_layers,
                  "params": cfg.param_count(), "init_s": init_s}
        launches, replayed = {}, {}
        for label, ps, batch, max_len, max_new in traffic:
            def make_engine(graphs, batch=batch, max_len=max_len, pack=1):
                # phase 3's 256-row chunk row, phase 4's 512 when packed
                return InferenceEngine(
                    cfg, device=DEV, params=params, max_batch=batch,
                    block_size=16, max_len=max_len,
                    max_num_batched_tokens=batch + (256 if pack == 1
                                                    else 512), seed=0,
                    prefill_pack=pack, cuda_graphs=graphs)

            def make_reqs(ps=ps, max_new=max_new):
                return [Request(p.copy(), max_new=max_new) for p in ps]

            tag = f"{arch} {label}"
            g, e, toks = serve_ab(torch, counters, card, tag, make_engine,
                                  make_reqs, max_new,
                                  ("paged_attention",
                                   "paged_prefill_attention", "gather"))
            static = static_vs_engine(torch, counters, params, cfg, ps,
                                      max_new, toks, tag)
            eng = make_engine(True, pack=4)
            packed, ptoks = serve(torch, counters, eng, make_reqs(max_new=4),
                                  4, ("ragged_paged_prefill_attention",
                                      "paged_attention", "gather"))
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            check(packed["most_chunks_in_a_step"] >= 2,
                  f"{tag}: no step carried two packed chunks")
            # two engine paths, each the engine's distance from the fp32
            # reading: they part only at a margin below twice that
            limit = max(TOL, 2 * static["fp32_err_engine"])
            margins = []
            packed["identical"] = sum(
                near_tie_or_same(torch, params, cfg, p, o, r[:4], limit,
                                 margins)
                for p, o, r in zip(ps, ptoks.values(), toks))
            packed["requests"], packed["margins"] = len(ps), margins
            print(f"[serve-family] {tag}: pack 4's 4 tokens == pack 1's "
                  f"first 4 on {packed['identical']}/{len(ps)} requests, the "
                  f"rest part at a near-tie: (step, top-2 margin, limit) "
                  f"{margins}", flush=True)
            for r in (g, e, static, packed):
                for k, n in r["launches"].items():
                    launches[k] = launches.get(k, 0) + n
            runs += [g, e, static, packed]
            for k, n in g["replayed_launches"].items():
                replayed[k] = replayed.get(k, 0) + n
            for k, n in packed["replayed_launches"].items():
                replayed[k] = replayed.get(k, 0) + n
            member[label] = {"graphs": g, "eager": e, "static": static,
                             "packed": packed}
            print(f"[serve-family] {card}: {tag}: {cfg.num_layers} layers "
                  f"({cfg.param_count() / 1e9:.2f} B params), CUDA graphs "
                  f"{g['tok_s']} tok/s (eager {e['tok_s']}), decode step "
                  f"{g['decode_step_ms_mean']:.2f} ms (device "
                  f"{g['decode_body_device_ms_mean']:.2f}; bytes floor "
                  f"{g['decode_floor_ms']:.2f}), chunk step "
                  f"{g['chunk_step_ms_mean']:.2f} ms, busy share "
                  f"{g['busy_share_events']:.3f}, TTFT median "
                  f"{g['ttft_s_median']:.3f} s, peak {g['peak_mem_gib']:.2f} "
                  f"GiB; pack 4: {packed['tok_s']} tok/s: "
                  f"{json.dumps(brief(member[label]))}", flush=True)
        for kernel in FAMILY_KERNELS:
            rows[kernel][name + "_launches"] = launches.get(kernel, 0)
            rows[kernel][name + "_replayed_launches"] = replayed.get(kernel,
                                                                     0)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# phase 11: abort, the host swap tier, the front end and the fleet
# ---------------------------------------------------------------------------

# 80 allocatable blocks: phase 3's traffic touches 16 + 8 x 18 = 160, and
# this pool swaps at least twice at pack 1 (at 100 blocks, once)
SWAP_BLOCKS = 81
SWAP_SPACE = 1 << 30
SHARED_SLOTS = 512              # the fleet's shared index: 320 MiB pinned
SWAP_KEYS = ("preemptions", "swap_preemptions", "swap_ins",
             "swapped_out_blocks", "swapped_in_blocks", "swapped_out_bytes",
             "swapped_in_bytes", "swap_d2h_s", "swap_h2d_s",
             "host_hit_blocks", "cache_hit_tokens", "swap_space_mib")


def phase3_prompts(cfg):
    """Phase 3's prompts: 8 of 512 tokens sharing a 256-token prefix."""
    import numpy as np
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
    return [np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, 256).astype(np.int32)])
        for _ in range(8)]


def glm4_engine(params, graphs=True, pack=1, **kw):
    """glm4_9b at phase 3's settings (8 slots, 16-token blocks, 256-row
    chunks; 512 when packed)."""
    from repro_torch.config import get_config
    from repro_torch.serving import InferenceEngine
    return InferenceEngine(get_config("glm4_9b"), device=DEV, params=params,
                           max_batch=8, block_size=16, max_len=1024, seed=0,
                           max_num_batched_tokens=8 + 256 * pack,
                           prefill_pack=pack, cuda_graphs=graphs, **kw)


def fleet_launches(counters, engines) -> tuple[dict, dict]:
    """``run_launches`` over engines that share the kernels' counters."""
    total = read_launches(counters)
    replayed = {}
    for eng in engines:
        if eng.graphs is not None:
            for (kernel, key), n in eng.graphs.run_launches().items():
                name = summary_name(kernel, key)
                replayed[name] = replayed.get(name, 0) + n
                total[name] = total.get(name, 0) + n
    return total, replayed


def first_diff(a, b):
    """(request, step) of the first differing token of two lists of
    streams, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, next((j for j, (p, q) in enumerate(zip(x, y))
                            if p != q), min(len(x), len(y)))
    return None


def same_streams(label, got, want) -> None:
    d = first_diff(got, want)
    check(d is None and len(got) == len(want),
          f"{label}: tokens differ (request, step) {d}")


def brief_swap(runs: dict) -> dict:
    keys = ("tok_s", "steps", "decode_step_ms_mean", "chunk_step_ms_mean",
            "ttft_s_median", "token_gap_s_median", "peak_mem_gib",
            "link_yardstick", "d2h_ms_per_swap", "h2d_ms_per_swap_in",
            "d2h_gb_s", "h2d_gb_s") + SWAP_KEYS
    return {k: {n: r[n] for n in keys if n in r} for k, r in runs.items()}


def link_yardstick(torch, nbytes: int) -> dict:
    """A plain pinned copy_ of ``nbytes`` each way, by CUDA events: the
    device <-> host link's rate beside the swap tier's copies."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEV)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out = {}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        dst.copy_(src, non_blocking=True)              # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        out[name + "_ms"], out[name + "_gb_s"] = ms, nbytes / ms / 1e6
    return out


def serve_swap(torch, counters, card, params) -> tuple[list, list]:
    """Phase 11a: phase 3's traffic over 100 blocks with a 1 GiB host tier,
    swap_policy "always", on graphs and eager; "never" (recompute); a pool
    that never preempts; then the same three over int8 pools at
    prefill_pack 4. Greedy tokens byte-identical in all, the swap runs'
    counters and the freed pools checked, the swap copies' times beside a
    plain pinned copy of the same bytes. Returns (runs, the bf16 no-preempt
    run's tokens in prompt order)."""
    from repro_torch.config import get_config
    from repro_torch.serving import Request
    from repro_torch.serving.kv_cache import block_bytes

    cfg = get_config("glm4_9b")
    prompts = phase3_prompts(cfg)
    runs, want = [], None
    for kv, pack in (("bf16", 1), ("int8", 4)):
        prefill = ("paged_prefill_attention" if pack == 1
                   else "ragged_paged_prefill_attention")
        expect = (variant(prefill, kv), variant("paged_attention", kv),
                  "gather")
        bb = block_bytes(cfg, 16, kv_dtype=kv)
        toks, res = {}, {}
        ways = [("swap", True, "always"), ("recompute", True, "never"),
                ("no_preempt", True, None)]
        if kv == "bf16":
            ways.insert(1, ("swap_eager", False, "always"))
        for label, graphs, policy in ways:
            kw = dict(kv_dtype=kv)
            if policy is not None:
                kw.update(num_blocks=SWAP_BLOCKS, swap_space_bytes=SWAP_SPACE,
                          swap_policy=policy)
            eng = glm4_engine(params, graphs, pack, **kw)
            r, t = serve(torch, counters, eng,
                         [Request(p.copy(), max_new=32) for p in prompts],
                         32, expect)
            r.update({k: eng.stats[k] for k in SWAP_KEYS},
                     label=f"11a {kv} pack {pack} {label}")
            check(eng.bm.stats().blocks_in_use == 0
                  and eng.bm.num_host_free == eng.bm.num_host_blocks,
                  f"{r['label']}: blocks or host slots left in use")
            eng.bm.check()
            toks[label], res[label] = list(t.values()), r
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        s, rc, n = res["swap"], res["recompute"], res["no_preempt"]
        check(s["swap_preemptions"] >= 2 and s["swap_ins"] >= 2,
              f"{kv}: {s['swap_preemptions']} swap preemptions, "
              f"{s['swap_ins']} swap-ins")
        check(s["swapped_out_bytes"] == s["swapped_out_blocks"] * bb
              and s["swapped_in_bytes"] == s["swapped_in_blocks"] * bb
              and 0 < s["swapped_in_blocks"] <= s["swapped_out_blocks"]
              + s["host_hit_blocks"],
              f"{kv}: swap counters {dict((k, s[k]) for k in SWAP_KEYS)}")
        check(rc["swap_preemptions"] == 0 and rc["preemptions"] >= 2
              and n["preemptions"] == 0,
              f"{kv}: recompute run {rc['preemptions']} preemptions, "
              f"no-preempt run {n['preemptions']}")
        for label in ("swap", "swap_eager"):
            if label in toks:
                same_streams(f"{kv} pack {pack}: {label} vs no-preempt",
                             toks[label], toks["no_preempt"])
        # recompute replays the generated tokens' KV through the chunk
        # path's GEMMs (256 or 512 rows, where decode wrote them with 8):
        # cuBLAS need not round a row alike at both shapes, so the streams
        # may part, but only at a near-tie (the rule of phases 6 and 10)
        margins = []
        rc["recompute_identical"] = sum(
            near_tie_or_same(torch, params, cfg, p, a, b, TOL, margins)
            for p, a, b in zip(prompts, toks["recompute"],
                               toks["no_preempt"]))
        rc["recompute_margins"] = margins
        per_swap = s["swapped_out_bytes"] // s["swap_preemptions"]
        link = link_yardstick(torch, per_swap)
        s.update(link_yardstick=link,
                 d2h_ms_per_swap=1e3 * s["swap_d2h_s"] / s["swap_preemptions"],
                 h2d_ms_per_swap_in=1e3 * s["swap_h2d_s"] / s["swap_ins"],
                 d2h_gb_s=s["swapped_out_bytes"] / max(s["swap_d2h_s"], 1e-12)
                 / 1e9,
                 h2d_gb_s=s["swapped_in_bytes"] / max(s["swap_h2d_s"], 1e-12)
                 / 1e9)
        print(f"[serve-swap] {card}: glm4_9b {kv} pools, pack {pack}, "
              f"{SWAP_BLOCKS - 1} blocks, 1 GiB host tier: swap == "
              f"no-preempt{' == swap eager' if kv == 'bf16' else ''} byte "
              f"for byte; recompute == no-preempt on "
              f"{rc['recompute_identical']}/{len(prompts)} requests, the "
              f"rest part at a near-tie (step, top-2 margin, limit) "
              f"{rc['recompute_margins']}; {s['swap_preemptions']} swap "
              f"preemptions "
              f"({s['preemptions']} in all), {s['swap_ins']} swap-ins, "
              f"{s['swapped_out_blocks']} blocks out / "
              f"{s['swapped_in_blocks']} in ({s['swapped_out_bytes']} / "
              f"{s['swapped_in_bytes']} bytes); d2h "
              f"{s['d2h_ms_per_swap']:.3f} ms a swap ({s['d2h_gb_s']:.2f} "
              f"GB/s), h2d {s['h2d_ms_per_swap_in']:.3f} ms a swap-in "
              f"({s['h2d_gb_s']:.2f} GB/s); a plain pinned copy of "
              f"{per_swap} bytes: d2h {link['d2h_ms']:.3f} ms "
              f"({link['d2h_gb_s']:.2f} GB/s), h2d {link['h2d_ms']:.3f} ms "
              f"({link['h2d_gb_s']:.2f} GB/s); tok/s swap {s['tok_s']}, "
              f"recompute {rc['tok_s']}, no-preempt {n['tok_s']}: "
              f"{json.dumps(brief_swap(res))}", flush=True)
        runs += list(res.values())
        if kv == "bf16":
            want = toks["no_preempt"]
    return runs, want


async def sse_client(port, prompt, max_new, drop_after=None):
    """POST /generate and read the SSE stream: (tokens, send time, token
    arrival times, the final rid or None). With ``drop_after`` the client
    disconnects after that many tokens."""
    import asyncio
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_new": max_new}).encode()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    t0 = time.monotonic()
    writer.write((f"POST /generate HTTP/1.1\r\nHost: t\r\nContent-Type: "
                  f"application/json\r\nContent-Length: {len(body)}\r\n\r\n"
                  ).encode() + body)
    await writer.drain()
    toks, times, rid = [], [], None
    while True:
        line = await reader.readline()
        if not line or line.strip() == b"data: [DONE]":
            break
        if not line.startswith(b"data: "):
            continue
        ev = json.loads(line[6:])
        if "token" in ev:
            toks.append(ev["token"])
            times.append(time.monotonic())
            if drop_after is not None and len(toks) == drop_after:
                break
        elif ev.get("done"):
            rid = ev["rid"]
    writer.close()
    return toks, t0, times, rid


async def http_get(port, path):
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body.decode()


def prometheus_samples(text: str) -> dict:
    """{sample name with labels: value} of Prometheus text; fails on a
    line that does not parse."""
    out = {}
    for ln in text.strip().split("\n"):
        if ln.startswith("#"):
            check(ln.startswith(("# HELP ", "# TYPE ")), f"metrics: {ln}")
            continue
        name, _, val = ln.rpartition(" ")
        try:
            out[name] = float(val)
        except ValueError:
            fail(f"metrics: sample line does not parse: {ln}")
    return out


def serve_abort_http(torch, counters, card, params, want) -> list:
    """Phase 11b: phase 3's 8 requests through an AsyncEngineDriver over
    the 11a swap engine; when request 0 has 4 tokens (in the engine
    thread, between steps) it and one waiting request (a swapped one if
    any) are aborted: the other 6 streams equal a run without the two,
    every block and host slot is free. Phase 11c: FrontendServer on
    127.0.0.1, 8 concurrent SSE clients with phase 3's prompts, one
    disconnecting after 4 tokens: the other 7 equal ``want`` (the no-
    preempt run's), one abort, /health 200, /metrics parses with
    repro_engine_tokens_total == the tokens streamed; TTFT and the token
    gap as the clients saw them. Returns the runs."""
    import asyncio
    from repro_torch.config import get_config
    from repro_torch.serving import Request
    from repro_torch.serving.frontend import AsyncEngineDriver, FrontendServer

    cfg = get_config("glm4_9b")
    prompts = phase3_prompts(cfg)
    swap_kw = dict(num_blocks=SWAP_BLOCKS, swap_space_bytes=SWAP_SPACE,
                   swap_policy="always")
    expect = ("paged_attention", "paged_prefill_attention", "gather")
    runs = []

    # -- 11b
    eng = glm4_engine(params, **swap_kw)
    eng.capture_graphs()
    drv = AsyncEngineDriver(eng)
    reqs = [Request(p.copy(), max_new=32, rid=1100 + i)
            for i, p in enumerate(prompts)]
    aborted = {}

    async def run_b():
        streams = [await drv.submit(r) for r in reqs]
        await drv.start()
        inner = eng.on_token

        def hook(req, tok, lp=None):
            inner(req, tok, lp)
            if req is reqs[0] and len(req.out) == 4 and not aborted:
                waiting = list(eng.sched.waiting)
                check(waiting, "11b: no waiting request to abort")
                other = next((r for r in waiting if eng.bm.is_swapped(r.rid)),
                             waiting[-1])
                aborted.update(running=req.rid, other=other.rid,
                               other_swapped=eng.bm.is_swapped(other.rid))
                drv.abort(req.rid)
                drv.abort(other.rid)
        eng.on_token = hook

        async def pull(s):
            return [ev.token async for ev in s]

        outs = await asyncio.gather(*(pull(s) for s in streams))
        await drv.aclose()
        return outs

    torch.cuda.synchronize()
    reset_launches(counters)
    t0 = time.monotonic()
    outs = asyncio.run(run_b())
    wall = time.monotonic() - t0
    launches, replayed = fleet_launches(counters, [eng])
    check(drv.aborted == 2 and eng.stats["aborts"] == 2,
          f"11b: driver aborted {drv.aborted}, engine {eng.stats['aborts']}")
    check(eng.bm.stats().blocks_in_use == 0
          and eng.bm.num_host_free == eng.bm.num_host_blocks,
          "11b: blocks or host slots left after the aborts")
    eng.bm.check()
    gone = {aborted["running"], aborted["other"]}
    check(4 <= len(outs[0]) < 32, f"11b: aborted stream has {len(outs[0])}")
    keep = [i for i, r in enumerate(reqs) if r.rid not in gone]
    res_b = {"label": "11b abort", "launches": launches,
             "replayed_launches": replayed, "wall_s": wall,
             "aborted": aborted, "tokens": eng.stats["tokens"],
             "swap_preemptions": eng.stats["swap_preemptions"]}
    del eng, drv
    gc.collect()
    twin = glm4_engine(params, **swap_kw)
    r, t = serve(torch, counters, twin,
                 [Request(prompts[i].copy(), max_new=32) for i in keep], 32,
                 expect)
    same_streams("11b: survivors vs a run without the aborted two",
                 [outs[i] for i in keep], list(t.values()))
    r["label"] = "11b twin"
    runs += [res_b, r]
    print(f"[serve-abort] {card}: glm4_9b, 8 requests through the driver "
          f"over the swap engine: aborted running rid {aborted['running']} "
          f"after {len(outs[0])} tokens and waiting rid {aborted['other']} "
          f"(swapped: {aborted['other_swapped']}); the 6 others == a run "
          f"without the two, byte for byte; blocks and host slots all free; "
          f"{res_b['swap_preemptions']} swap preemptions in the run",
          flush=True)
    del twin
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11c
    eng = glm4_engine(params)
    eng.capture_graphs()
    drv = AsyncEngineDriver(eng)
    pushed = {}
    drop = 5

    async def run_c():
        await drv.start()
        inner = eng.on_token

        def count(req, tok, lp=None):
            pushed[req.rid] = pushed.get(req.rid, 0) + 1
            inner(req, tok, lp)
        eng.on_token = count
        srv = FrontendServer(drv, host="127.0.0.1", port=0)
        await srv.start()
        clients = await asyncio.gather(*(
            sse_client(srv.port, p, 32, 4 if i == drop else None)
            for i, p in enumerate(prompts)))
        for _ in range(400):
            if drv.aborted:
                break
            await asyncio.sleep(0.05)
        health = await http_get(srv.port, "/health")
        metrics = await http_get(srv.port, "/metrics")
        await drv.aclose()
        await srv.aclose()
        return clients, health, metrics

    torch.cuda.synchronize()
    reset_launches(counters)
    t0 = time.monotonic()
    clients, health, metrics = asyncio.run(run_c())
    wall = time.monotonic() - t0
    launches, replayed = fleet_launches(counters, [eng])
    check(health[0] == 200 and json.loads(health[1])["status"] == "ok",
          f"11c: /health {health}")
    check(metrics[0] == 200, f"11c: /metrics status {metrics[0]}")
    samples = prometheus_samples(metrics[1])
    done_rids = {c[3] for c in clients if c[3] is not None}
    check(len(done_rids) == 7 and drv.dropped_streams == 1
          and drv.aborted == 1 and eng.stats["aborts"] == 1,
          f"11c: {len(done_rids)} streams completed, dropped "
          f"{drv.dropped_streams}, aborts {eng.stats['aborts']}")
    dropped_rid = next(r for r in pushed if r not in done_rids)
    streamed = sum(len(c[0]) for c in clients if c[3] is not None) \
        + pushed[dropped_rid]
    check(samples.get("repro_engine_tokens_total") == streamed
          == eng.stats["tokens"] and samples.get(
              "repro_engine_aborts_total") == 1,
          f"11c: repro_engine_tokens_total "
          f"{samples.get('repro_engine_tokens_total')} vs streamed "
          f"{streamed} (engine {eng.stats['tokens']})")
    same_streams("11c: HTTP streams vs engine.run()",
                 [c[0] for i, c in enumerate(clients) if i != drop],
                 [w for i, w in enumerate(want) if i != drop])
    ttft = [c[2][0] - c[1] for c in clients]
    gaps = [b - a for c in clients for a, b in zip(c[2], c[2][1:])]
    res_c = {"label": "11c http", "launches": launches,
             "replayed_launches": replayed, "wall_s": wall,
             "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
             "token_gap_s_median": statistics.median(gaps),
             "token_gap_s_max": max(gaps), "tokens": eng.stats["tokens"],
             "dropped_after": len(clients[drop][0])}
    runs.append(res_c)
    print(f"[serve-http] {card}: glm4_9b behind FrontendServer, 8 SSE "
          f"clients, one gone after 4 tokens: 7 streams == engine.run(), "
          f"1 abort, /health 200, /metrics parses "
          f"(repro_engine_tokens_total {streamed:.0f} == streamed); as the "
          f"clients saw it: TTFT median {res_c['ttft_s_median']:.3f} s max "
          f"{res_c['ttft_s_max']:.3f} s, token gap median "
          f"{1e3 * res_c['token_gap_s_median']:.2f} ms max "
          f"{1e3 * res_c['token_gap_s_max']:.2f} ms", flush=True)
    del eng, drv
    gc.collect()
    torch.cuda.empty_cache()
    return runs


class CaptureWatch:
    """Times every capture and replay of a fleet's engines, so the run can
    show one replica capturing in the middle of another's run (and that
    the device lock kept the other's replays out of the capture)."""

    def __init__(self, engines):
        self.captures, self.replays = [], []
        for i, eng in enumerate(engines):
            g = eng.graphs
            capture, replay = g.capture, g.replay

            def timed_capture(key, i=i, capture=capture):
                t = time.monotonic()
                capture(key)
                self.captures.append((i, key, t, time.monotonic()))

            def timed_replay(key, i=i, replay=replay):
                self.replays.append((i, time.monotonic()))
                return replay(key)
            g.capture, g.replay = timed_capture, timed_replay

    def around(self, mode) -> tuple[int, int, int]:
        """Replays of the other replicas before, inside and after the
        captures in ``mode``."""
        out = [0, 0, 0]
        for i, key, t0, t1 in self.captures:
            if key[1] == mode:
                for j, t in self.replays:
                    if j != i:
                        out[(t >= t0) + (t > t1)] += 1
        return tuple(out)


def serve_fleet(torch, counters, card, params, want, dp1_tok_s) -> list:
    """Phase 11d: ReplicaRouter over 2 glm4 engines on the one card sharing
    the weights and one SharedPrefixIndex (512 slots), phase 3's 8
    requests, plus a full-sampling request submitted mid-run (its replica
    captures the full graphs while the other replays; its tokens and
    logprobs equal its eager run alone); then disaggregate with one
    prefill replica. Tokens byte-identical to dp = 1 (``want``), blocks
    published and adopted across replicas. Returns the runs."""
    import asyncio
    from repro_torch.config import get_config
    from repro_torch.serving import (ReplicaRouter, Request, SamplingParams,
                                     SharedPrefixIndex)
    from repro_torch.serving.kv_cache import block_bytes

    cfg = get_config("glm4_9b")
    prompts = phase3_prompts(cfg)
    full_sp = SamplingParams(temperature=0.8, top_p=0.9, min_p=0.05,
                             repetition_penalty=1.1, logprobs=3, seed=7)
    bb = block_bytes(cfg, 16)
    runs = []
    full_out = None
    for label, rkw in (("dp2", {}), ("disagg", dict(disaggregate=True,
                                                    n_prefill=1))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shared = SharedPrefixIndex(num_slots=SHARED_SLOTS)
        engines = [glm4_engine(params, shared_index=shared)
                   for _ in range(2)]
        for eng in engines:
            eng.capture_graphs()
        check(all(e.params is params for e in engines),
              f"{label}: replicas do not share the weights")
        watch = CaptureWatch(engines)
        timing = {"publish_s": 0.0, "adopt_s": 0.0}
        for eng in engines:
            for name, key in (("_flush_shared_publish", "publish_s"),
                              ("_shared_in", "adopt_s")):
                fn = getattr(eng, name)

                def timed(*a, fn=fn, key=key):
                    t = time.monotonic()
                    fn(*a)
                    timing[key] += time.monotonic() - t
                setattr(eng, name, timed)
        router = ReplicaRouter(engines, **rkw)
        reqs = [Request(p.copy(), max_new=32, rid=1200 + i)
                for i, p in enumerate(prompts)]
        full_req = Request(prompts[3].copy(), max_new=16, sampling=full_sp,
                           rid=1300)

        async def go():
            streams = [await router.submit(r) for r in reqs]
            await router.start()
            first = await streams[0].__anext__()
            sfull = None
            if label == "dp2":               # mid-run: a new (shape, mode)
                sfull = await router.submit(full_req)

            async def pull(s):
                evs = [ev async for ev in s]
                return [e.token for e in evs], [e.logprobs for e in evs]

            outs = await asyncio.gather(*(pull(s) for s in streams))
            full = await pull(sfull) if sfull is not None else None
            await router.aclose()
            return [[first.token] + outs[0][0]] + [o[0] for o in outs[1:]], \
                full

        torch.cuda.synchronize()
        reset_launches(counters)
        t0 = time.monotonic()
        outs, full = asyncio.run(go())
        wall = time.monotonic() - t0
        launches, replayed = fleet_launches(counters, engines)
        same_streams(f"11d {label} vs dp 1", outs, want)
        published = sum(e.stats["shared_published_blocks"] for e in engines)
        adopted = sum(e.stats["shared_hit_blocks"] for e in engines)
        check(published > 0 and adopted > 0,
              f"11d {label}: published {published}, adopted {adopted}")
        shared.check()
        tokens = sum(e.stats["tokens"] for e in engines)
        res = {"label": f"11d {label}", "launches": launches,
               "replayed_launches": replayed, "wall_s": wall,
               "tok_s": tokens / wall, "routed": list(router.routed),
               "handoffs": router.handoffs,
               "published_blocks": published, "adopted_blocks": adopted,
               "adopted_bytes": adopted * bb, **timing,
               "shared": shared.stats(),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "captures": [(i, list(k)) for i, k, _, _ in watch.captures]}
        if full is not None:
            before, inside, after = watch.around("full")
            res["other_replays_around_full_captures"] = [before, inside,
                                                          after]
            check(before > 0 and after > 0 and inside == 0,
                  "11d: the full graphs' captures were not in the middle "
                  "of the other replica's run, or overlapped its replays "
                  f"(before, inside, after: {before}, {inside}, {after}; "
                  f"captures {res['captures']})")
            full_out = full
        if label == "disagg":
            check(router.handoffs == 8 and engines[1].stats[
                "cache_hit_tokens"] > 0, f"11d disagg: {router.handoffs} "
                "handoffs, the decode replica adopted nothing")
        runs.append(res)
        print(f"[serve-fleet] {card}: glm4_9b {label} (2 replicas on one "
              f"card, shared weights, {SHARED_SLOTS}-slot shared index, "
              f"{shared.num_slots * bb / 2 ** 20:.0f} MiB pinned): tokens == "
              f"dp 1 byte for byte; routed {router.routed}, handoffs "
              f"{router.handoffs}; {published} blocks published, "
              f"{adopted} adopted across replicas ({adopted * bb} bytes; "
              f"publish copies {timing['publish_s']:.3f} s, adoption copies "
              f"{timing['adopt_s']:.3f} s); {res['tok_s']:.1f} tok/s "
              f"(dp 1: {dp1_tok_s}; one card, not a speed claim); peak "
              f"{res['peak_mem_gib']:.2f} GiB"
              + ("; the other replica's replays before, inside and after "
                 "the mid-run full-sampling captures: "
                 f"{res['other_replays_around_full_captures']}"
                 if full is not None else ""), flush=True)
        del router, engines, shared, watch
        gc.collect()
        torch.cuda.empty_cache()
    # the mid-run full-sampling request against its eager run alone
    eager = glm4_engine(params, graphs=False)
    lps = []
    eager.on_token = lambda r, t, lp: lps.append(lp)
    got = eager.run([Request(prompts[3].copy(), max_new=16, sampling=full_sp,
                             rid=1300)])[1300].tolist()
    check(full_out[0] == got and full_out[1] == lps,
          f"11d: the full-sampling request on the fleet {full_out[0]} != "
          f"its eager run {got} (or its logprobs differ)")
    print(f"[serve-fleet] {card}: the mid-run full-sampling request (t 0.8, "
          f"top-p 0.9, min-p 0.05, repetition 1.1, logprobs 3): tokens and "
          f"logprobs == its eager run alone", flush=True)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def serve_tiers(torch, counters, card, params, parts="abcd") -> list:
    """Phase 11 (a-d) on phase 3's weights; ``parts`` picks some (a
    development run: without "a", one no-preempt run gives the tokens the
    others are held to). Prints the phase's launches by kernel (replay-
    aware, summed over its runs). Returns the runs."""
    from repro_torch.serving import Request
    if "a" in parts:
        runs, want = serve_swap(torch, counters, card, params)
        dp1 = next(r for r in runs
                   if r["label"] == "11a bf16 pack 1 no_preempt")
    else:
        from repro_torch.config import get_config
        dp1, toks = serve(torch, counters, glm4_engine(params),
                          [Request(p.copy(), max_new=32) for p in
                           phase3_prompts(get_config("glm4_9b"))], 32, ())
        runs, want = [dp1], list(toks.values())
    if "b" in parts or "c" in parts:
        runs += serve_abort_http(torch, counters, card, params, want)
    if "d" in parts:
        runs += serve_fleet(torch, counters, card, params, want,
                            dp1["tok_s"])
    launches = {}
    for r in runs:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    print(f"[serve-tiers] {card}: phase 11's launches by kernel "
          f"(replay-aware): {json.dumps(launches)}", flush=True)
    return runs


# ---------------------------------------------------------------------------
# phase 6: card vs CPU at smoke size
# ---------------------------------------------------------------------------


def last_logits(torch, params, cfg, tokens, kv, device="cpu"):
    """fp32 logits after ``tokens`` on ``device`` (the parameters' own),
    by one monolithic chunk from fresh state (block 0 is the trash
    block)."""
    from repro_torch.models import transformer
    from repro_torch.serving.runners import make_runner

    n = len(tokens)
    nb = -(-n // 16)
    cache = make_runner(cfg).init_cache(nb + 1, 16, 1, device, kv)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32,  # noqa: E731
                                 device=device)
    batch = {"tokens": i32([list(tokens)]), "q_start": i32([0]),
             "q_lens": i32([n]), "block_tables": i32([list(range(1, nb + 1))]),
             "ctx_lens": i32([n])}
    with torch.no_grad():
        lg, _ = transformer.prefill_chunk_paged(params, cache, batch, cfg)
    return lg[0, :cfg.vocab_size]


def compare_card_cpu(torch, cfg, params, prompts, arrivals, label, pack=1,
                     kv="bf16", **kw):
    """One smoke engine run on the card and one on the CPU, same weights
    and requests: greedy tokens equal, or the first difference at a top-2
    margin below the bf16 tolerance. Returns (card outputs, margins)."""
    import numpy as np
    from repro_torch.models.api import params_to
    from repro_torch.serving import InferenceEngine, Request

    outs = {}
    for dev in (DEV, "cpu"):
        eng = InferenceEngine(cfg, device=dev, params=params_to(params, dev),
                              prefill_pack=pack, kv_dtype=kv,
                              debug_invariants=True, **kw)
        reqs = [Request(p.copy(), max_new=20) for p in prompts]
        got = eng.run(reqs, arrival_steps=arrivals)
        outs[dev] = [got[r.rid].tolist() for r in reqs]
        if cfg.ssm is None or cfg.shared_attn_period:
            check(eng.stats["preemptions"] >= 1,
                  f"{dev} {label}: smoke run did not preempt")
        if cfg.ssm is None:
            check(eng.stats["cow_copies"] >= 1,
                  f"{dev} {label}: smoke run did not copy-on-write")
        else:
            check(eng.stats["quantum_dropped_tokens"] > 0,
                  f"{dev} {label}: no chunk was quantized")
    margins = []
    for p, a, b in zip(prompts, outs[DEV], outs["cpu"]):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        lg = last_logits(torch, params, cfg,
                         np.concatenate([p, np.asarray(b[:i], np.int32)]), kv)
        top = torch.topk(lg, 2)
        margin = float(top.values[0] - top.values[1])
        margins.append(margin)
        check(margin < TOL and {a[i], b[i]} == set(top.indices.tolist()),
              f"{label}: card and CPU differ at step {i} with top-2 margin "
              f"{margin}")
    same = sum(a == b for a, b in zip(outs[DEV], outs["cpu"]))
    print(f"[card-vs-cpu] {label}: {same}/{len(prompts)} requests "
          f"token-identical; first-difference top-2 margins: {margins}",
          flush=True)
    return outs[DEV], {"identical": same, "margins": margins}


def card_vs_cpu(torch):
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models.api import init_model

    cfg = get_config("glm4_9b", smoke=True)
    params = init_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)
                               .astype(np.int32)]), prefix.copy(),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 13)
                               .astype(np.int32)]),
               rng.integers(0, cfg.vocab_size, 20).astype(np.int32)]
    kw = dict(max_batch=2, block_size=16, max_len=96, num_blocks=8,
              max_num_batched_tokens=2 + 12)
    outs, summary = {}, {}
    for pack, kv in ((1, "bf16"), (4, "bf16"), (4, "int8"), (1, "fp8")):
        outs[pack, kv], summary[f"pack{pack}_{kv}"] = compare_card_cpu(
            torch, cfg, params, prompts, [0, 5, 9, 9],
            f"glm4 smoke, prefill_pack {pack}, {kv} pools", pack, kv, **kw)
    check(outs[4, "bf16"] == outs[1, "bf16"],
          "on the card, prefill_pack 4 and 1 gave different bf16 tokens")
    print("[card-vs-cpu] on the card, prefill_pack 4 == prefill_pack 1 "
          "(bf16), token for token", flush=True)
    # gemma2: its 16-token window (prompts of 20-45 tokens), both softcaps,
    # scale 1/4 and post-block norms through the hd-16 kernels
    cfg = get_config("gemma2_27b", smoke=True)
    params = init_model(cfg, seed=0, device="cpu")
    for pack in (1, 4):
        _, summary[f"gemma2_pack{pack}"] = compare_card_cpu(
            torch, cfg, params, prompts, [0, 5, 9, 9],
            f"gemma2 smoke, prefill_pack {pack}, bf16 pools", pack, **kw)
    # SSM and hybrid: quantized chunks (a 13-token budget over 8-token SSD
    # chunks), staggered arrivals; zamba2 also preempts (7 blocks of 16)
    for arch in ("mamba2_370m", "zamba2_2p7b"):
        cfg = get_config(arch, smoke=True)
        params = init_model(cfg, seed=0, device="cpu")
        prompts = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
                   for _ in range(4)]
        kw = dict(max_batch=2, block_size=16, max_len=96,
                  max_num_batched_tokens=2 + 13)
        if cfg.shared_attn_period:
            kw["num_blocks"] = 8
        _, summary[arch] = compare_card_cpu(
            torch, cfg, params, prompts, [0, 0, 3, 5], f"{arch} smoke", **kw)
    return summary


# ---------------------------------------------------------------------------
# phases 7-8: training
# ---------------------------------------------------------------------------

# Phase 7's optimizer: AdamW with fp32 slots, the JAX driver's learning
# rate (1e-3) with a 2-step warmup and cosine decay over the 6 steps
TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_LAYERS = 6, 2, 2048, 8


def train_full(torch, counters, card):
    """Phase 7: glm4_9b at full width, 8 of its 40 layers (the fp32
    masters and AdamW slots of 40 do not fit one card), seeded random
    init, remat full, B=2 x S=2048 from ShardedSource(seed=0), through
    ``launch.train.train``. Every loss finite and the last below the
    first; on step 1 every parameter leaf has a finite, non-zero gradient;
    the flash kernel launched 2 x layers x steps times (forward and remat
    recompute) and the gather once per step (the embedding)."""
    import dataclasses
    from repro_torch.config import OptimizerConfig, ParallelConfig, get_config
    from repro_torch.launch.train import train
    from repro_torch.optim.optimizers import tree_leaves

    cfg = dataclasses.replace(get_config("glm4_9b"), num_layers=TRAIN_LAYERS)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    pcfg = ParallelConfig(remat="full", microbatches=1)
    steps, grads_seen = [], []

    def grad_hook(grads):
        if grads_seen:
            return
        leaves = tree_leaves(grads)
        grads_seen.append(len(leaves))
        for i, g in enumerate(leaves):
            check(bool(torch.isfinite(g).all()) and bool((g != 0).any()),
                  f"train: parameter leaf {i} {tuple(g.shape)} has a "
                  "non-finite or all-zero gradient on step 1")

    # unreachable tensors of the serving phases (reference cycles) wait for
    # Python's collector: free them, so the peak is the training run's
    gc.collect()
    print(f"[mem] before training: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counters)
    t0 = time.monotonic()
    params, state, losses = train(
        cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S, pcfg=pcfg,
        ocfg=ocfg, device=DEV, seed=0, log_every=1,
        on_step=lambda s, m, sec: steps.append(
            dict(step=s, loss=float(m["loss"]),
                 grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                 ms=1e3 * sec, tok_s=TRAIN_B * TRAIN_S / sec)),
        grad_hook=grad_hook)
    wall = time.monotonic() - t0
    launches = read_launches(counters)
    check(all(map(math.isfinite, losses)), f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: last loss {losses[-1]} is not "
          f"below the first {losses[0]}")
    check(grads_seen == [3 + 9 * TRAIN_LAYERS],
          f"train: gradient leaves {grads_seen}")
    want = {"flash_attention": 2 * TRAIN_LAYERS * TRAIN_STEPS,
            "gather": TRAIN_STEPS}
    for name, n in want.items():
        check(launches.get(name) == n, f"train: {name} launched "
              f"{launches.get(name)} times, not {n}")
    check(not launches.get("flash_attention_mma"), "train: the hd-16 flash "
          f"route launched {launches.get('flash_attention_mma')} times at "
          "full width")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    profile = profile_train_step(torch, cfg, pcfg, ocfg, params, state)
    del params, state
    later = steps[1:]
    res = dict(arch="glm4_9b", layers=TRAIN_LAYERS, params=cfg.param_count(),
               batch=TRAIN_B, seq=TRAIN_S, remat="full", optimizer="adamw",
               losses=losses, steps=steps, wall_s=wall,
               step_ms_mean=sum(x["ms"] for x in later) / len(later),
               tok_s_mean=sum(x["tok_s"] for x in later) / len(later),
               peak_mem_gib=peak, launches=launches, profile=profile)
    print(f"[train] {card}: glm4_9b full width, {TRAIN_LAYERS} layers "
          f"({res['params'] / 1e9:.2f} B params), B={TRAIN_B} S={TRAIN_S}, "
          f"remat full, AdamW: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"step {res['step_ms_mean']:.1f} ms ({res['tok_s_mean']:.0f} "
          f"tok/s) over steps 2-{TRAIN_STEPS}, peak "
          f"{res['peak_mem_gib']:.2f} GiB, launches {launches}: "
          f"{json.dumps(res)}", flush=True)
    torch.cuda.empty_cache()
    return res


def profile_train_step(torch, cfg, pcfg, ocfg, params, state, top=15):
    """One more training step (batch index TRAIN_STEPS) under
    torch.profiler, after the timed run: device time by kernel and the
    device's busy share of the step's wall time (kernel times summed).
    Returns {"wall_ms", "device_ms", "top": [[name, ms, calls], ...]}."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import ShardedSource
    from repro_torch.spmd.steps import make_train_step

    step = make_train_step(cfg, pcfg, ocfg)
    batch = {k: torch.from_numpy(np.array(v)).to(DEV) for k, v in
             ShardedSource(cfg, TRAIN_S, seed=0).batch(
                 TRAIN_STEPS, TRAIN_B).items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, _, m = step(params, state, TRAIN_STEPS, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in events) / 1e3
    out = {"wall_ms": 1e3 * wall, "device_ms": total,
           "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                   for e in events[:top]]}
    print(f"[train-profile] one step: device {total:.1f} ms over "
          f"{1e3 * wall:.1f} ms wall (profiled), busy share "
          f"{total / (1e3 * wall):.3f}", flush=True)
    for name, ms, n in out["top"]:
        print(f"[train-profile] {ms:9.2f} ms {100 * ms / total:5.1f}% "
              f"{n:6d}x {name}", flush=True)
    return out


def train_card_vs_cpu(torch):
    """Phase 8: glm4 smoke on the card and on the CPU from the same fp32
    masters, the same three batches, two microbatches, remat full, SGD.
    The card attends through the flash kernel and the plain backward, the
    CPU through dense_attention under autograd. Losses within TOL per
    step, grad norms within TOL relative, each fp32 master within TOL of
    the largest master update."""
    import numpy as np
    from repro_torch.config import (OptimizerConfig, ParallelConfig,
                                    get_config)
    from repro_torch.data.pipeline import ShardedSource
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import init_model
    from repro_torch.optim import optimizers as opt
    from repro_torch.spmd.steps import make_train_step

    cfg = get_config("glm4_9b", smoke=True)
    ocfg = OptimizerConfig(name="sgd", lr=0.1, warmup_steps=0,
                           schedule="constant")
    pcfg = ParallelConfig(remat="full", microbatches=2)
    init = init_model(cfg, seed=0, device="cpu", dtype=torch.float32)
    src = ShardedSource(cfg, 32, seed=0)
    batches = [src.batch(i, 4) for i in range(3)]
    runs = {}
    for dev in (DEV, "cpu"):
        state = opt.init_train_state(ocfg, opt.tree_map(
            lambda t: t.to(dev, copy=True), init))     # updated in place
        params = opt.working_params(state)
        step = make_train_step(cfg, pcfg, ocfg)
        launches = fa.flash_attention.launches["mma"]
        metrics = []
        for s, b in enumerate(batches):
            params, state, m = step(params, state, s, {
                k: torch.from_numpy(np.array(v)).to(dev)
                for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        if dev != "cpu":
            n = fa.flash_attention.launches["mma"] - launches
            check(n == 3 * 2 * 2 * cfg.num_layers,
                  "train card-vs-cpu: the flash kernel (route mma, hd "
                  f"{cfg.head_dim}) did not run every layer of every "
                  f"microbatch twice on the card ({n} launches)")
        runs[dev] = (metrics, [t.cpu() for t in opt.tree_leaves(
            state["master"])])
    (m_card, w_card), (m_cpu, w_cpu) = runs[DEV], runs["cpu"]
    w0 = opt.tree_leaves(init)
    for a, b in zip(m_card, m_cpu):
        check(abs(a["loss"] - b["loss"]) <= TOL
              and abs(a["grad_norm"] - b["grad_norm"]) <= TOL * b["grad_norm"],
              f"train card-vs-cpu: card {a}, cpu {b}")
    upd = max(float((b - c).abs().max()) for b, c in zip(w_cpu, w0))
    diff = max(float((a - b).abs().max()) for a, b in zip(w_card, w_cpu))
    check(upd > 0, "train card-vs-cpu: the masters did not move")
    check(diff <= TOL * upd, f"train card-vs-cpu: masters differ by "
          f"{diff}, {diff / upd} of the largest update {upd}")
    print(f"[train-card-vs-cpu] glm4 smoke, 3 SGD steps, 2 microbatches: "
          f"losses card {[m['loss'] for m in m_card]} cpu "
          f"{[m['loss'] for m in m_cpu]}; grad norms card "
          f"{[m['grad_norm'] for m in m_card]} cpu "
          f"{[m['grad_norm'] for m in m_cpu]}; masters within "
          f"{diff / upd:.3g} of the largest update", flush=True)
    return {"masters_err_over_update": diff / upd}


def build_report(log: str) -> None:
    """ptxas' registers and spills per kernel, and every warning or C75xx
    note, as [build] lines. Fails if ptxas serialized sampled_softmax.cu's
    wgmma pipeline (WGMMA_SERIALIZED)."""
    src = fn = ""            # the source and entry function ptxas reports on
    for line in log.splitlines():
        if line.startswith("=="):
            src = line.strip("= ")
            print(f"[build] {line.strip()}")
        elif "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        elif "registers" in line or "spill" in line:
            print(f"[build] {fn}: {line.strip()}")
        elif "warning" in line or re.search(r"C75\d\d", line):
            print(f"[build] {src}: {line.strip()}")
            check(src != "sampled_softmax.cu" or not any(
                c in line for c in WGMMA_SERIALIZED),
                f"ptxas serialized {src}'s wgmma pipeline: {line.strip()}")


def main() -> int:
    # a hang anywhere (a driver thread, a capture) prints every thread's
    # stack and ends the run before its time limit
    dev_run = sys.argv[1:2] == ["--phase"]
    faulthandler.dump_traceback_later(420 if dev_run else WATCHDOG_S,
                                      exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch (run it from "
              "the repo)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.serving.graphs import KERNELS

    # decode_logits must be a true fp32 product on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.monotonic()
    libs = build.build_all()
    print(f"[build] {sorted(libs)} in {time.monotonic() - t0:.1f}s "
          f"({build.build_dir()})", flush=True)
    log = build.build_dir() / "build.log"
    if log.exists():
        build_report(log.read_text())

    if dev_run and sys.argv[2].startswith("11"):
        # a development run: phase 11 (or its parts "11bd", ...) alone, on
        # fresh phase-3 weights; no summary and no result line
        from repro_torch.config import get_config
        from repro_torch.models.api import init_model
        serve_tiers(torch, KERNELS, card,
                    init_model(get_config("glm4_9b"), 0, DEV),
                    sys.argv[2][2:] or "abcd")
        print("[phase 11] passed (a partial run: no result line)")
        return 0
    timer = Timer(torch)
    rows = check_kernels(torch, timer)
    del timer
    torch.cuda.empty_cache()
    counters = KERNELS            # every kernel wrapper and its counter
    res, params = serve_full(torch, counters, card)
    runs = [res] + serve_packed(torch, counters, card, params)
    sampling_runs, verify_launches = serve_sampling(torch, counters, card,
                                                    params)
    runs += sampling_runs
    rows["paged_prefill_attention"].update(verify_launches)
    runs += serve_tiers(torch, counters, card, params)
    del params
    torch.cuda.empty_cache()
    runs += serve_ssm(torch, counters, card)
    card_vs_cpu(torch)
    runs.append(train_full(torch, counters, card))
    train_card_vs_cpu(torch)
    runs += serve_family(torch, counters, card, rows)

    launches = {name: sum(r["launches"].get(name, 0) for r in runs)
                for name in rows}
    for name, n in launches.items():
        # sampled_softmax_loss is on no model path, in this package or in
        # the JAX package (the models' sampled softmax is plain tensor
        # code): phase 2e launches it and holds it against its plain version
        if name != "sampled_softmax_loss":
            check(n > 0, f"kernel {name} never launched on a serving or "
                  "training path")
    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=REPLACES[r["kernel"]], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    **{k: v for k, v in r.items() if k in SUMMARY_EXTRAS
                       or k.startswith(("no_write", "device_ms", "hd80_",
                                        "zamba2_", "verify_",
                                        "plain_device_ms",
                                        "library_device_ms")
                                       + tuple(f"{m}_" for m in FAMILY))})
               for name, r in rows.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
