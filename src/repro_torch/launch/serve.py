"""Serving driver for the PyTorch port: a synthetic Poisson workload through
the continuous-batching engine (port of ``repro.launch.serve`` without the
async front-end, fleets or meshes, which later slices bring).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4_9b --smoke \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --prefill-pack 4 --kv-dtype int8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --temperature 0.8 --top-p 0.9 --repetition-penalty 1.2 --logprobs 3 \\
      --stop 5,7 --min-new 2
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --num-speculative-tokens 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_27b \\
      --smoke --device cpu --prompt-len 40
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4_9b --no-smoke

The default device is the card ("cuda"), where the engine runs its step
as CUDA graphs, one per (shape, sampling mode); ``--device cpu`` runs the
plain PyTorch paths instead of the CUDA kernels, eagerly.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.config import PORTED_ARCHS, get_config


def poisson_arrival_steps(n: int, rate: float, rng) -> list[int]:
    """Arrival step indices for a Poisson process with ``rate`` requests
    per engine step (the engine's virtual clock)."""
    t, out = 0.0, []
    for _ in range(n):
        t += rng.exponential(1.0 / max(rate, 1e-9))
        out.append(int(t))
    return out


def make_requests(cfg, args, rng):
    from repro_torch.serving import Request, SamplingParams
    reqs = []
    for i in range(args.requests):
        # staggered horizons: each request retires on its own max_new
        max_new = max(1, args.max_new - (i % 4) * args.max_new // 4)
        stop = tuple(tuple(int(t) for t in s.split(","))
                     for s in (args.stop or []))
        sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                            seed=i, top_p=args.top_p, min_p=args.min_p,
                            repetition_penalty=args.repetition_penalty,
                            presence_penalty=args.presence_penalty,
                            frequency_penalty=args.frequency_penalty,
                            logprobs=args.logprobs, stop=stop)
        reqs.append(Request(
            rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new=max_new, sampling=sp, eos_id=args.eos_id,
            min_new=min(args.min_new, max_new)))
    return reqs


def profiled_run(eng, reqs, arrivals, top: int):
    """``eng.run`` under ``torch.profiler``; prints the ``top`` operators
    and kernels by device time and the device's busy share of the run's
    wall time (kernel time summed, so overlapping kernels count twice)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        outs = eng.run(reqs, arrival_steps=arrivals)
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" or eng.device.type == "cpu"]
    key = ("self_device_time_total" if eng.device.type == "cuda"
           else "self_cpu_time_total")
    events.sort(key=lambda e: getattr(e, key), reverse=True)
    total_us = sum(getattr(e, key) for e in events)
    wall_us = eng.stats["wall_s"] * 1e6
    print(f"[profile] {eng.device.type} time {total_us / 1e3:.1f} ms over "
          f"{eng.stats['wall_s']:.3f} s wall: busy share "
          f"{total_us / max(wall_us, 1e-9):.3f}")
    for e in events[:top]:
        t = getattr(e, key)
        print(f"[profile] {t / 1e3:10.2f} ms {100 * t / max(total_us, 1e-9):5.1f}%"
              f" {e.count:7d}x  {e.key[:90]}")
    return outs


def run_engine(cfg, args):
    from repro_torch.serving import InferenceEngine
    draft_cfg = (get_config(args.speculative_draft, smoke=args.smoke)
                 if args.speculative_draft else None)
    eng = InferenceEngine(
        cfg, device=args.device, max_batch=args.max_batch,
        block_size=args.block_size, max_len=args.max_len,
        num_blocks=args.num_blocks,
        max_num_batched_tokens=args.max_batched_tokens,
        enable_prefix_caching=not args.no_prefix_caching, seed=args.seed,
        prefill_pack=args.prefill_pack, kv_dtype=args.kv_dtype,
        draft_cfg=draft_cfg,
        num_speculative_tokens=args.num_speculative_tokens)
    if eng.device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()            # compile before, not inside, the run
        eng.capture_graphs()         # and capture the step graphs
    rng = np.random.default_rng(args.seed)
    reqs = make_requests(cfg, args, rng)
    arrivals = poisson_arrival_steps(len(reqs), args.rate, rng)
    if args.profile:
        outs = profiled_run(eng, reqs, arrivals, args.profile)
    else:
        outs = eng.run(reqs, arrival_steps=arrivals)
    s = eng.stats
    print(f"[serve] device={eng.device} arch={cfg.name} "
          f"kv_dtype={s['kv_dtype']} prefill_pack={eng.prefill_pack} "
          f"kv_cache_mib={s['kv_cache_mib']} "
          f"slot_state_mib={s['slot_state_mib']}")
    print(f"[serve] runner={type(eng.runner).__name__} {len(reqs)} requests "
          f"(poisson rate={args.rate}/step, arrivals={arrivals}), "
          f"{s['tokens']} tokens in {s['wall_s']:.2f}s "
          f"({s['tok_s']:.1f} tok/s)")
    print(f"[serve] steps={s['steps']} "
          f"prefill_chunks={s['prefill_chunks']} "
          f"preemptions={s['preemptions']} "
          f"cache_hit_tokens={s['cache_hit_tokens']} "
          f"cow_copies={s['cow_copies']} "
          f"peak_block_util={s['peak_block_utilization']:.2f} "
          f"cache_hit_rate={eng.cache_hit_rate:.3f} "
          f"ttft_p95={eng.hist['ttft_steps'].percentile(95):.0f}steps "
          f"graph_captures={s['graph_captures']} "
          f"graph_replays={s['graph_replays']}")
    print(f"[serve] full_sampling_steps={s['full_sampling_steps']} "
          f"stop_hits={s['stop_hits']} "
          f"mean_accept_len={eng.mean_accept_len:.3f}")
    print("[serve] sample output ids:", outs[reqs[0].rid][:8].tolist())
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4_9b",
                    choices=PORTED_ARCHS)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="smoke-size config (default; --no-smoke for full)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size in blocks (default: sized for "
                         "max_batch x max_len)")
    ap.add_argument("--max-batched-tokens", type=int, default=None,
                    help="per-step token budget across decodes + the "
                    "prefill chunks (default: max_batch + 2*block_size)")
    ap.add_argument("--no-prefix-caching", action="store_true")
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=("bf16", "int8", "fp8"),
                    help="KV page-pool storage dtype; int8/fp8 keep fp32 "
                    "per-row scales beside the pools, dequantized inside "
                    "the attention kernels")
    ap.add_argument("--prefill-pack", type=int, default=1,
                    help="most prefill chunks packed into one step's flat "
                    "ragged token row (1 = one chunk per step)")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="poisson arrivals per engine step")
    ap.add_argument("--speculative-draft", default=None,
                    help="draft-model arch for speculative decoding "
                    "(defaults to --arch, a fresh-init self-draft, when "
                    "--num-speculative-tokens > 0)")
    ap.add_argument("--num-speculative-tokens", type=int, default=0,
                    help="draft tokens proposed per slot per step; the "
                    "target verifies k+1 positions in one widened step "
                    "(0 disables speculation)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off); composes "
                    "with --top-k / --min-p")
    ap.add_argument("--min-p", type=float, default=0.0,
                    help="min-p truncation relative to the max "
                    "probability (0 = off)")
    ap.add_argument("--repetition-penalty", type=float, default=1.0,
                    help="divide positive / multiply negative logits of "
                    "already-seen tokens (1.0 = off)")
    ap.add_argument("--presence-penalty", type=float, default=0.0,
                    help="subtract once per distinct generated token")
    ap.add_argument("--frequency-penalty", type=float, default=0.0,
                    help="subtract per occurrence of a generated token")
    ap.add_argument("--logprobs", type=int, default=0,
                    help="per-token top-N logprobs (0 = off)")
    ap.add_argument("--stop", action="append", default=None,
                    metavar="IDS",
                    help="stop sequence as comma-separated token ids; "
                    "repeatable (each flag adds one sequence)")
    ap.add_argument("--min-new", type=int, default=0,
                    help="ignore EOS / stop sequences before this many "
                    "generated tokens (max_new still wins)")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="run under torch.profiler and print the N "
                    "kernels with the most device time (0 = off)")
    args = ap.parse_args(argv)
    import torch
    # decode_logits must be a true fp32 product on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_engine(get_config(args.arch, smoke=args.smoke), args)


if __name__ == "__main__":
    main()
