#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

  python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases, each of which raises on failure:
  1. card: name and power limit (nvidia-smi); build the CUDA kernels from
     src/repro_torch/csrc with nvcc, all sources in parallel.
  2. kernels vs plain versions on the card, at glm4_9b's widths (H=32,
     K=2, hd=128, 16-token pages, 8 sequences up to 2048 tokens, a
     256-row prefill chunk, a 151552 x 4096 embedding table), bf16: each
     output row within 1e-2 relative, every value within 1e-2 absolute;
     a 1-row chunk equals a decode step bit for bit; inactive and padding
     rows are exact zeros; window + softcap at hd 128 and 16.
     Times each kernel, its plain version and the one-call library
     equivalent where there is one, with the L2 cache flushed per call.
  3. serving: glm4_9b at full width and depth (40 layers, random weights
     from a seed) through repro_torch.serving.InferenceEngine: 8 requests
     of 512 tokens sharing a 256-token prefix, 32 new tokens each, 256-
     token chunks. Every kernel's launch count is zeroed before the run
     and must be positive after it.
  4. card vs CPU: the same engine at glm4 smoke size on both, same
     weights and requests; greedy tokens must agree, except after a first
     difference whose top-2 logit margin is below the bf16 tolerance.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or run from a
directory that does not hold the repo, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
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


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work on the card: bytes over HBM rate or
    operations over the bf16 peak, whichever is larger."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


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
    """Kernel vs plain: every row within TOL relative, and TOL absolute
    as an outer cap. Returns (max abs err, max row relative err)."""
    e, r = err(a, b), row_err(a, b)
    check(e <= TOL and r <= TOL, f"{name}: max abs err {e}, max row "
          f"relative err {r} (limit {TOL})")
    return e, r


def check_kernels(torch, timer):
    from repro_torch.kernels import embedding as emb
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import paged_chunk_attention_xla

    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    H, K, hd, bs = 32, 2, 128, 16
    rows = {}

    # decode: 8 sequences, contexts up to 2048, one inactive slot
    ctx = [2048, 1536, 1024, 777, 2000, 1, 0, 300]
    B, nb = len(ctx), 2048 // bs
    q, kp, vp, bt, ctxt = paged_case(torch, gen, B, H, K, hd, bs, nb, ctx)
    o_k = pa.paged_attention(q, kp, vp, bt, ctxt)
    o_p = ref.paged_attention_ref(q, kp, vp, bt, ctxt)
    e, rel = check_close("paged_attention vs plain", o_k, o_p)
    check(bool((o_k[6] == 0).all()), "paged_attention: ctx=0 row not zero")
    # a one-row chunk is a decode step, bit for bit
    o_c = pa.paged_prefill_attention(
        q[:, None].contiguous(), kp, vp, bt, ctxt,
        torch.ones(B, dtype=torch.int32, device=DEV))
    check(torch.equal(o_c[:, 0], o_k), "chunk(C=1) != decode bitwise")
    S = sum(ctx)
    b_dec = (2 * q.numel() * 2 + 2 * S * K * hd * 2 + bt.numel() * 4
             + B * 4)
    rows["paged_attention"] = dict(
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:203",
        max_abs_err=e, max_row_rel_err=rel,
        ms=timer(lambda: pa.paged_attention(q, kp, vp, bt, ctxt)),
        plain_ms=timer(lambda: ref.paged_attention_ref(q, kp, vp, bt, ctxt)),
        library_ms=None,
        shape=f"B={B} H={H} K={K} hd={hd} bs={bs} ctx={ctx}",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(b_dec, 4.0 * S * H * hd))))

    # chunked prefill: one 256-row chunk ending at 2048 tokens, 200 rows
    # valid (the rest are padding and must come out as exact zeros)
    C, qlen, ctx1 = 256, 200, 2048
    q, kp, vp, bt, ctxt = paged_case(torch, gen, 1, H, K, hd, bs, nb, [ctx1],
                                     C=C)
    ql = torch.tensor([qlen], dtype=torch.int32, device=DEV)
    o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql)
    o_p = paged_chunk_attention_xla(q, kp, vp, bt, ctxt, ql)
    e, rel = check_close("paged_prefill_attention vs plain",
                         o_k[:, :qlen], o_p[:, :qlen])
    check(bool((o_k[:, qlen:] == 0).all()), "chunk padding rows not zero")
    keys = sum(ctx1 - qlen + i + 1 for i in range(qlen))   # causal pairs
    b_chk = 2 * q.numel() * 2 + 2 * ctx1 * K * hd * 2 + bt.numel() * 4 + 8
    rows["paged_prefill_attention"] = dict(
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:417",
        max_abs_err=e, max_row_rel_err=rel,
        ms=timer(lambda: pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql)),
        plain_ms=timer(lambda: paged_chunk_attention_xla(q, kp, vp, bt,
                                                         ctxt, ql)),
        library_ms=None,
        shape=f"B=1 C={C} q_len={qlen} ctx={ctx1} H={H} K={K} hd={hd}",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(b_chk, 4.0 * keys * H * hd))))

    # window + softcap, multi-sequence chunks with an empty one, at the
    # full head dim and the smoke head dim
    for (Hs, Ks, hds) in ((H, K, hd), (4, 2, 16)):
        q, kp, vp, bt, ctxt = paged_case(torch, gen, 3, Hs, Ks, hds, bs, 8,
                                         [128, 37, 0], C=40)
        ql = torch.tensor([40, 11, 0], dtype=torch.int32, device=DEV)
        kw = dict(window=50, cap=30.0)
        o_k = pa.paged_prefill_attention(q, kp, vp, bt, ctxt, ql, **kw)
        o_r = ref.paged_prefill_attention_ref(q, kp, vp, bt, ctxt, ql, **kw)
        check_close(f"window+cap chunk hd={hds}", o_k, o_r)
        check(bool((o_k[1, 11:] == 0).all() and (o_k[2] == 0).all()),
              f"window+cap chunk hd={hds}: padding rows not zero")
        q1 = q[:, 0].contiguous()
        ctx_d = torch.tensor([128, 27, 0], dtype=torch.int32, device=DEV)
        o_d = pa.paged_attention(q1, kp, vp, bt, ctx_d, **kw)
        check_close(f"window+cap decode hd={hds}", o_d,
                    ref.paged_attention_ref(q1, kp, vp, bt, ctx_d, **kw))
        print(f"[kernels] window=50 cap=30 hd={hds}: chunk and decode "
              f"within {TOL}", flush=True)

    # embedding gather from the full glm4 table: a 256-token chunk row
    # (the decode batch's 8 ids are checked too)
    V, d = 151552, 4096
    table = torch.randn((V, d), generator=gen, device=DEV).bfloat16()
    ids = torch.randint(0, V, (1, 256), generator=gen, device=DEV,
                        dtype=torch.int32)
    ids8 = torch.randint(0, V, (8, 1), generator=gen, device=DEV,
                         dtype=torch.int32)
    check(torch.equal(emb.gather(table, ids), emb.gather_plain(table, ids))
          and torch.equal(emb.gather(table, ids8),
                          emb.gather_plain(table, ids8)),
          "gather != table[ids]")
    flat = ids.reshape(-1)
    rows["gather"] = dict(
        source="src/repro_torch/csrc/embedding.cu",
        replaces="src/repro/kernels/embedding.py:23",
        max_abs_err=0.0, max_row_rel_err=0.0,
        ms=timer(lambda: emb.gather(table, ids)),
        plain_ms=timer(lambda: emb.gather_plain(table, ids)),
        library_ms=timer(lambda: torch.index_select(table, 0, flat)),
        shape=f"table {V}x{d} bf16, ids (1, 256); decode ids (8, 1): "
              f"{timer(lambda: emb.gather(table, ids8)):.4f} ms",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(2 * 256 * d * 2 + 256 * 4, 0.0))))
    del table
    for name, r in rows.items():
        print(f"[kernels] {name}: {r['shape']}: kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err']:.3g} "
              f"max_row_rel_err={r['max_row_rel_err']:.3g}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 3: serve glm4_9b at full width and depth
# ---------------------------------------------------------------------------


def serve_full(torch, counters, card):
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.serving import InferenceEngine, Request

    cfg = get_config("glm4_9b")
    t0 = time.monotonic()
    eng = InferenceEngine(cfg, device=DEV, max_batch=8, block_size=16,
                          max_len=1024, max_num_batched_tokens=8 + 256,
                          seed=0)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    check(eng.chunk_width == 256, f"chunk width {eng.chunk_width}")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
    reqs = [Request(np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, 256).astype(np.int32)]),
        max_new=32) for _ in range(8)]

    # instrument the runner: per-step wall time and finite logits
    step_s, finite = [], []
    run_step, sample = eng.runner.step, eng.runner._sample

    def timed_step(*a, **kw):
        t = time.monotonic()
        out = run_step(*a, **kw)
        step_s.append((kw["has_chunk"], time.monotonic() - t))
        return out

    def checked_sample(logits_d, logits_c, a):
        for lg in (logits_d, logits_c):
            if lg is not None:
                finite.append(bool(torch.isfinite(
                    lg[:, :cfg.vocab_size]).all()))
        return sample(logits_d, logits_c, a)

    eng.runner.step, eng.runner._sample = timed_step, checked_sample
    for fn in counters:
        fn.launches = 0
    outs = eng.run(reqs)
    launches = {fn.__name__: fn.launches for fn in counters}
    s = eng.stats
    for r in reqs:
        o = outs[r.rid]
        check(len(o) == 32, f"request {r.rid}: {len(o)} tokens, not 32")
        check(bool(((o >= 0) & (o < cfg.vocab_size)).all()),
              f"request {r.rid}: token out of range")
    check(all(finite), "non-finite logits")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    check(s["cache_hit_tokens"] > 0, "no prefix-cache hits")
    check(s["prefill_chunks"] > len(reqs), "no prompt took two chunks")
    chunk_s = [t for c, t in step_s if c]
    dec_s = [t for c, t in step_s if not c]
    lat = [s["latency"][r.rid] for r in reqs]
    ttft = [x["first_token_wall"] - x["arrival_wall"] for x in lat]
    gap = [(x["done_wall"] - x["first_token_wall"]) / 31 for x in lat]
    res = {"params": cfg.param_count(), "init_s": init_s,
           "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
           "token_gap_s_median": statistics.median(gap),
           "token_gap_s_max": max(gap),
           "tok_s": s["tok_s"], "wall_s": s["wall_s"], "steps": s["steps"],
           "tokens": s["tokens"], "first_step_s": step_s[0][1],
           "chunk_step_ms_mean": 1e3 * sum(chunk_s[1:]) / max(
               len(chunk_s) - 1, 1),
           "decode_step_ms_mean": 1e3 * sum(dec_s) / max(len(dec_s), 1),
           "chunk_steps": len(chunk_s), "decode_steps": len(dec_s),
           "cache_hit_tokens": s["cache_hit_tokens"],
           "prefill_chunks": s["prefill_chunks"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches}
    print(f"[serve] {card}: glm4_9b full width, 40 layers "
          f"({res['params'] / 1e9:.2f} B params): {res['tok_s']} tok/s, "
          f"decode step {res['decode_step_ms_mean']:.1f} ms, chunk step "
          f"{res['chunk_step_ms_mean']:.1f} ms: {json.dumps(res)}",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 4: card vs CPU at smoke size
# ---------------------------------------------------------------------------


def card_vs_cpu(torch):
    import numpy as np
    from repro_torch.config import get_config
    from repro_torch.models import transformer
    from repro_torch.models.api import init_model, params_to
    from repro_torch.serving import InferenceEngine, Request
    from repro_torch.serving.kv_cache import init_paged_cache

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
              max_num_batched_tokens=2 + 12, debug_invariants=True)
    outs = {}
    for dev in (DEV, "cpu"):
        eng = InferenceEngine(cfg, device=dev, params=params_to(params, dev),
                              **kw)
        reqs = [Request(p.copy(), max_new=20) for p in prompts]
        got = eng.run(reqs, arrival_steps=[0, 5, 9, 9])
        outs[dev] = [got[r.rid].tolist() for r in reqs]
        check(eng.stats["preemptions"] >= 1 and eng.stats["cow_copies"] >= 1,
              f"{dev}: smoke run did not preempt and copy-on-write")
    margins = []
    for p, a, b in zip(prompts, outs[DEV], outs["cpu"]):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        toks = np.concatenate([p, np.asarray(b[:i], np.int32)])
        n = len(toks)
        nb = -(-n // 16)
        cache = init_paged_cache(cfg, nb + 1, 16, "cpu")
        i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
        batch = {"tokens": i32([toks.tolist()]), "q_start": i32([0]),
                 "q_lens": i32([n]),
                 "block_tables": i32([list(range(1, nb + 1))]),
                 "ctx_lens": i32([n])}
        with torch.no_grad():
            lg, _ = transformer.prefill_chunk_paged(params, cache, batch, cfg)
        top = torch.topk(lg[0, :cfg.vocab_size], 2)
        margin = float(top.values[0] - top.values[1])
        margins.append(margin)
        check(margin < TOL and {a[i], b[i]} == set(top.indices.tolist()),
              f"card and CPU differ at step {i} with top-2 margin {margin}")
    same = sum(a == b for a, b in zip(outs[DEV], outs["cpu"]))
    print(f"[card-vs-cpu] glm4 smoke: {same}/{len(prompts)} requests "
          f"token-identical; first-difference top-2 margins: {margins}",
          flush=True)
    return {"identical": same, "requests": len(prompts), "margins": margins}


def main() -> int:
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
    from repro_torch.kernels import embedding as emb
    from repro_torch.kernels import paged_attention as pa

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
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print(f"[build] {line.strip()}")

    timer = Timer(torch)
    rows = check_kernels(torch, timer)
    del timer
    torch.cuda.empty_cache()
    counters = (pa.paged_attention, pa.paged_prefill_attention, emb.gather)
    serve = serve_full(torch, counters, card)
    card_vs_cpu(torch)

    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"],
                    launches=serve["launches"][name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for name, r in rows.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
