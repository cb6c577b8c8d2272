#!/usr/bin/env python3
"""Repeat chip_smoke phase 17b's glm4_9b runs and say whether every run
gives the same bits: in fresh processes, and in this one after its free
device memory was filled with stale bytes or while another stream runs.

  python3 tools/tp_repeat.py [N] [--layers L] [--history]   # one card

``--history`` first runs chip_smoke.py's phases 2-16 in this process
(``chip_smoke.earlier_phases``), as its whole run does before phase 17:
the first run below then has that history behind it.

glm4_9b (full width, full depth or L layers) on phase 3's traffic (8 x
512 with a 256-token shared prefix, 32 new), eager, through
``chip_smoke.tp_serve``, which reads every emitted token's fp32 logits row
(a bit digest and the top-2 margin) and every decoder block's digests:

1. in this process: a first run, a second one, one after each fill of the
   caching allocator's free memory (0x00, 0xFF, 0x7F, random bytes: a
   kernel that read memory it did not write would part), one while
   another thread runs bf16 GEMMs on a stream of its own;
2. the decode and chunk kernels at glm4's widths after each fill (their
   outputs must be the same bits);
3. N rounds (default 1) of a fresh process (tp = 1) and two fresh ranks
   (mesh model=2; gloo with both on cuda:0 on a one-card machine).

Every run is held against the first with ``chip_smoke.parting``: the
first token, logits row and block digest that differ (None: the same
bits). Prints the card's name and power limit first and one JSON line per
run; exits 1 when any run parts from the first.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FILLS = {"0x00": 0x00, "0xFF": 0xFF, "0x7F": 0x7F, "random": None}


def fill_free_memory(torch, byte, keep_bytes=8 << 30) -> None:
    """Fill the device memory the caching allocator can hand out with
    ``byte`` (random bytes for None) and leave it cached: 1 GiB blocks of
    all but ``keep_bytes`` of the free memory and 1 GiB of 512 KiB small
    blocks. The next allocations reuse those bytes."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    held = []
    for n in [1 << 30] * max(0, (free - keep_bytes) >> 30) + [1 << 19] * 2048:
        t = torch.empty(n, dtype=torch.uint8, device="cuda")
        if byte is None:
            t.random_(0, 256)
        else:
            t.fill_(byte)
        held.append(t)
    torch.cuda.synchronize()
    del held


def kernel_fills(torch) -> bool:
    """Step 2: the decode and chunk kernels' output bits after each fill."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, K, hd, bs, nb = 8, 32, 2, 128, 16, 64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    n_pages = B * nb + 1
    k_pages, v_pages = randn(n_pages, bs, K, hd), randn(n_pages, bs, K, hd)
    tables = torch.randperm(n_pages - 1, generator=gen, device="cuda")[
        :B * nb].reshape(B, nb).to(torch.int32)
    ctx = torch.tensor([1000, 513, 64, 1, 0, 777, 1024, 300],
                       dtype=torch.int32, device="cuda")
    q, qc = randn(B, H, hd), randn(2, 256, H, hd)
    ctx_c = torch.tensor([1024, 700], dtype=torch.int32, device="cuda")
    q_lens = torch.tensor([256, 200], dtype=torch.int32, device="cuda")
    ok, first = True, None
    for name, byte in FILLS.items():
        fill_free_memory(torch, byte)
        got = {"decode": ops.paged_attention(q, k_pages, v_pages, tables,
                                             ctx),
               "chunk": ops.paged_prefill_attention(
                   qc, k_pages, v_pages, tables[:2], ctx_c, q_lens)}
        got = {k: v.view(torch.int16).clone() for k, v in got.items()}
        first = first or got
        for k, v in got.items():
            same = bool(torch.equal(v, first[k]))
            ok = ok and same
            print(json.dumps({"kernel": k, "after fill": name,
                              "bits equal to the first fill's": same}),
                  flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rounds", type=int, nargs="?", default=1)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--history", action="store_true",
                    help="run chip_smoke's phases 2-16 here first")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.serving.graphs import KERNELS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    build.build_all()
    if args.history:
        import time
        cs.earlier_phases(torch, cs.card_line(), time.monotonic())
        cs.free(torch)
    case = ("glm4_9b", args.layers, 32)

    def here():
        cfg, reqs, kw = cs.tp_case(*case)
        return cs.tp_serve(torch, KERNELS, cfg, reqs, kw)

    base = here()
    same = True

    def held(name, run) -> None:
        nonlocal same
        part = cs.parting(base, run)
        same = same and all(v is None for v in part.values())
        print(json.dumps({"run": name, "tok_s": run["tok_s"], **part}),
              flush=True)

    held("this process, again", here())
    for name, byte in FILLS.items():
        fill_free_memory(torch, byte)
        held(f"this process, after fill {name}", here())
    stop = threading.Event()

    def gemms():
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            a = torch.randn(4096, 4096, device="cuda").bfloat16()
            while not stop.is_set():
                for _ in range(8):
                    a @ a
                s.synchronize()
    t = threading.Thread(target=gemms, daemon=True)
    t.start()
    try:
        run = here()
    finally:
        stop.set()
        t.join()
    held("this process, GEMMs on another stream", run)
    same = kernel_fills(torch) and same
    cs.free(torch)
    for i in range(args.rounds):
        held(f"round {i}: fresh process, tp = 1",
             cs.spawn_ranks(1, (case,))[0]["runs"]["glm4_9b"])
        two = cs.spawn_ranks(2, (case,))
        for rank in (0, 1):
            held(f"round {i}: fresh ranks, tp = 2, rank {rank}",
                 two[rank]["runs"]["glm4_9b"])
    print(json.dumps({"all_runs_agree": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
