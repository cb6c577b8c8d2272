"""Serving driver for the PyTorch port (port of ``repro.launch.serve``):
a synthetic Poisson workload through the continuous-batching engine,
through a data-parallel fleet of engines behind one ``ReplicaRouter``
(``--dp``, ``--disaggregate``), or a long-lived HTTP server (``--http``:
SSE token streaming, /health, /metrics; SIGINT/SIGTERM drains
gracefully). ``--mesh data=A,model=B`` spawns A x B ranks (processes,
``torch.distributed``) and serves the workload tensor-parallel over each
"model" group (the data axis replicates): one engine a rank, the page
pools sharded by kv head; rank 0 prints the summary with a mesh line.

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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_moe_30b_a3b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_large_v3 \\
      --smoke --device cpu --prompt-len 8 --max-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --num-blocks 8 --max-batch 2 --swap-space-bytes 1048576 \
      --swap-policy always
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --dp 2 [--disaggregate]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4_9b --smoke \
      --device cpu --http 127.0.0.1:8000 [--dp 2] [--ttft-slo-ms 5000]
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --mesh model=2

The default device is the card ("cuda"), where the engine runs its step
as CUDA graphs, one per (shape, sampling mode); ``--device cpu`` runs the
plain PyTorch paths instead of the CUDA kernels, eagerly.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import time

import numpy as np

from repro_torch.config import ARCHS, get_config
from repro_torch.launch.mesh import parse_mesh


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
        frames = None
        if cfg.frontend == "audio":
            # the stub frontend's frame embeddings, one set per request
            frames = rng.normal(0, 1, (cfg.encoder_seq_len, cfg.d_model)
                                ).astype(np.float32)
        reqs.append(Request(
            rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new=max_new, sampling=sp, eos_id=args.eos_id,
            min_new=min(args.min_new, max_new), frames=frames))
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


def build_engine(cfg, args, shared_index=None, params=None,
                 draft_params=None, mesh=None):
    """One engine from the CLI's options (one rank's of ``mesh``); on the
    card its kernels are built and, without tensor parallelism, its
    greedy step graphs captured before it serves."""
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
        num_speculative_tokens=args.num_speculative_tokens,
        swap_space_bytes=args.swap_space_bytes,
        swap_policy=args.swap_policy, shared_index=shared_index,
        params=params, draft_params=draft_params, mesh=mesh)
    if eng.device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()            # compile before, not inside, the run
        eng.capture_graphs()         # and capture the step graphs
    return eng


def build_fleet(cfg, args):
    """``--dp`` identical engines around one SharedPrefixIndex, behind a
    ReplicaRouter. Replica 0 initialises the weights; the others share
    them by reference (the replicas must be identical for routing to be
    output-invariant): a speculative engine's target and draft both."""
    from repro_torch.serving import ReplicaRouter, SharedPrefixIndex
    shared = SharedPrefixIndex(num_slots=args.shared_slots)
    first = build_engine(cfg, args, shared_index=shared)
    if first.draft_cfg is not None:
        share = dict(params=first.params["tgt"],
                     draft_params=first.params["dft"])
    else:
        share = dict(params=first.params)
    engines = [first] + [build_engine(cfg, args, shared_index=shared,
                                      **share)
                         for _ in range(args.dp - 1)]
    return ReplicaRouter(engines, admission=build_controller(args, args.dp),
                         disaggregate=args.disaggregate,
                         n_prefill=args.n_prefill)


def build_controller(args, n_replicas: int = 1):
    from repro_torch.serving.frontend import AdmissionController
    slo = args.ttft_slo_ms / 1e3 if args.ttft_slo_ms else None
    return AdmissionController(ttft_slo_p95_s=slo, max_queue=args.max_queue,
                               n_replicas=n_replicas)


def run_engine(cfg, args, mesh=None, report=True):
    """The synthetic workload through one engine (on a mesh: this rank's;
    a group's rank 0 drives it, the others follow). Prints the summary
    where ``report``."""
    eng = build_engine(cfg, args, mesh=mesh)
    rng = np.random.default_rng(args.seed)
    reqs = make_requests(cfg, args, rng)
    arrivals = poisson_arrival_steps(len(reqs), args.rate, rng)
    if eng.group is not None and eng.group.rank != 0:
        return eng.follow()
    if args.profile:
        outs = profiled_run(eng, reqs, arrivals, args.profile)
    else:
        outs = eng.run(reqs, arrival_steps=arrivals)
    eng.close()
    if not report:
        return outs
    s = eng.stats
    if mesh is not None:
        print(f"[serve] mesh data={mesh.shape[0]} model={mesh.shape[1]}: "
              f"tp={eng.tp} backend={args.backend} ranks={args.world}, "
              f"kv-head pools sharded ({s['kv_cache_mib']} MiB a rank), "
              f"gathers={s['tp_gathers']} "
              f"gather_bytes={s['tp_gather_bytes']} "
              f"staged_copies={s['tp_staged_copies']} "
              f"staged_bytes={s['tp_staged_bytes']}")
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
    print(f"[serve] encodes={s['encodes']} "
          f"full_sampling_steps={s['full_sampling_steps']} "
          f"stop_hits={s['stop_hits']} "
          f"mean_accept_len={eng.mean_accept_len:.3f}")
    if s["swap_space_mib"]:
        print(f"[serve] swap_space_mib={s['swap_space_mib']} "
              f"swap_preemptions={s['swap_preemptions']} "
              f"swap_ins={s['swap_ins']} "
              f"swapped_out_blocks={s['swapped_out_blocks']} "
              f"swapped_in_blocks={s['swapped_in_blocks']}")
    print("[serve] sample output ids:", outs[reqs[0].rid][:8].tolist())
    return outs


def _mesh_rank(rank, args, init_method):
    """One rank of ``--mesh``: join the group, build the mesh, serve."""
    import torch

    from repro_torch.launch.mesh import init_rank, make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, model = parse_mesh(args.mesh)
    dev_type = torch.device(args.device).type
    args.world = data * model
    args.backend = init_rank(rank, args.world, init_method, dev_type)
    mesh = make_host_mesh(data, model, dev_type)
    run_engine(get_config(args.arch, smoke=args.smoke), args, mesh,
               report=rank == 0)
    torch.distributed.destroy_process_group()


def run_mesh(args):
    """``--mesh``: spawn the A x B ranks, wait for every one; fails if any
    rank does."""
    import tempfile
    from pathlib import Path

    import torch
    import torch.multiprocessing as mp
    data, model = parse_mesh(args.mesh)
    if torch.device(args.device).type == "cuda":
        from repro_torch.kernels import build
        build.build_all()            # once, before the ranks load it
    init = "file://" + str(Path(tempfile.mkdtemp(prefix="mesh_"))
                           / "rendezvous")
    mp.start_processes(_mesh_rank, args=(args, init), nprocs=data * model,
                       join=True, start_method="spawn")


def run_router(cfg, args):
    """The synthetic Poisson workload through a data-parallel fleet."""
    router = build_fleet(cfg, args)
    rng = np.random.default_rng(args.seed)
    reqs = make_requests(cfg, args, rng)
    arrivals = poisson_arrival_steps(len(reqs), args.rate, rng)
    t0 = time.time()
    outs = router.run(reqs, arrival_steps=arrivals)
    dt = time.time() - t0
    tokens = sum(router.replica_stats("tokens"))
    shared = router.shared_stats()
    roles = (f" roles=prefill{router._prefill_ids}/decode"
             f"{router._decode_ids}" if router.disaggregate else "")
    print(f"[serve] router: dp={router.dp} "
          f"disaggregate={router.disaggregate} routed={router.routed} "
          f"handoffs={router.handoffs} shared_hit_blocks="
          f"{sum(router.replica_stats('shared_hit_blocks'))} "
          f"shared_published_blocks={shared['published_blocks']} "
          f"shared_evicted_blocks={shared['evicted_blocks']}" + roles)
    print(f"[serve] fleet: {len(reqs)} requests (poisson rate={args.rate}"
          f"/step), {tokens} tokens in {dt:.2f}s "
          f"({tokens / max(dt, 1e-9):.1f} tok/s) "
          f"steps={router.replica_stats('steps')} "
          f"preemptions={router.replica_stats('preemptions')} "
          f"cache_hit_tokens={router.replica_stats('cache_hit_tokens')}")
    ctl = router.admission
    print(f"[serve] frontend: submitted={ctl.submitted} shed={ctl.shed} "
          f"completed={ctl.completed} queue_peak={ctl.queue_peak}")
    print("[serve] sample output ids:", outs[reqs[0].rid][:8].tolist())
    return outs


async def serve_http(driver, host, port, stop=None, on_ready=None):
    """Serve ``driver`` (an AsyncEngineDriver or a ReplicaRouter) over
    HTTP until ``stop`` is set (default: SIGINT or SIGTERM), then drain:
    no new admissions, in-flight requests finish. ``on_ready(server)`` is
    called once the server listens."""
    from repro_torch.serving.frontend import FrontendServer
    await driver.start()
    srv = FrontendServer(driver, host=host, port=port)
    await srv.start()
    ctl = driver.admission
    slo = ctl.ttft_slo_p95_s
    engines = getattr(driver, "engines", None) or [driver.engine]
    print(f"[serve] http listening on {host}:{srv.port} "
          f"replicas={len(engines)} (POST /generate, GET /health, "
          f"GET /metrics; ttft_slo_p95={slo if slo is not None else 'off'} "
          f"max_queue={ctl.max_queue})", flush=True)
    if on_ready is not None:
        on_ready(srv)
    if stop is None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    running = sum(len(e.sched.running) for e in engines)
    print(f"[serve] draining: no new admissions, finishing "
          f"{running + driver.queue_depth} in-flight request(s)", flush=True)
    await driver.aclose()
    await srv.aclose()
    tokens = sum(e.stats["tokens"] for e in engines)
    done = sum(e.stats["requests_done"] for e in engines)
    print(f"[serve] drained cleanly: requests_done={done} tokens={tokens} "
          f"shed={ctl.shed} aborts={sum(e.stats['aborts'] for e in engines)}",
          flush=True)
    return srv


def run_http(cfg, args, stop=None):
    """``--http``: one engine behind an AsyncEngineDriver, or (``--dp``
    > 1) a fleet behind its router, served until ``stop`` or a signal."""
    from repro_torch.serving.frontend import AsyncEngineDriver
    host, _, port = args.http.rpartition(":")
    if args.dp > 1:
        driver = build_fleet(cfg, args)
    else:
        driver = AsyncEngineDriver(build_engine(cfg, args),
                                   admission=build_controller(args))
    return asyncio.run(serve_http(driver, host or "127.0.0.1", int(port),
                                  stop))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4_9b",
                    choices=ARCHS)
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
    ap.add_argument("--swap-space-bytes", type=int, default=0,
                    help="pinned host memory for swap preemption, bytes (0 "
                    "= recompute only): a victim's KV moves to the host "
                    "and back when the cost model prefers it")
    ap.add_argument("--swap-policy", default="auto",
                    choices=("auto", "always", "never"),
                    help="swap or recompute per preemption victim: auto = "
                    "the measured-rate cost model; always/never force one")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel engine replicas behind one "
                    "ReplicaRouter (threads in one process, one card; "
                    "least-outstanding-tokens routing, a shared prefix "
                    "index)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="prefill/decode roles: the first --n-prefill "
                    "replicas prefill (a 1-token probe), the rest decode; "
                    "the KV hands off as hashed blocks through the shared "
                    "index (needs --dp >= 2)")
    ap.add_argument("--n-prefill", type=int, default=1,
                    help="prefill-role replicas under --disaggregate")
    ap.add_argument("--shared-slots", type=int, default=512,
                    help="host slots (blocks) of the fleet's "
                    "SharedPrefixIndex, LRU-evicted")
    ap.add_argument("--mesh", default=None, metavar="data=A,model=B",
                    help="spawn A x B ranks and serve tensor-parallel over "
                    "each 'model' group (page pools sharded by kv head; "
                    "the data axis replicates): NCCL when every rank has "
                    "a card of its own, else gloo")
    ap.add_argument("--http", default=None, metavar="HOST:PORT",
                    help="serve over HTTP until SIGINT/SIGTERM instead of "
                    "the synthetic workload: POST /generate (SSE), GET "
                    "/health, GET /metrics; port 0 picks a free one")
    ap.add_argument("--ttft-slo-ms", type=float, default=None,
                    help="TTFT p95 target in ms; admission sheds (429 + "
                    "Retry-After) when its projection exceeds it")
    ap.add_argument("--max-queue", type=int, default=128,
                    help="front-end queue bound; requests past it are "
                    "shed")
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
    if args.disaggregate and args.dp < 2:
        ap.error("--disaggregate needs --dp >= 2 (prefill + decode roles)")
    if args.mesh:
        try:
            parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
        if args.http or args.dp > 1:
            ap.error("--mesh with --http or --dp: a router or front end "
                     "over tensor-parallel engines is not ported yet "
                     "(ROADMAP.md queue 1 item 12)")
    return args


def main(argv=None):
    args = parse_args(argv)
    import torch
    # decode_logits must be a true fp32 product on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.mesh:
        run_mesh(args)
    elif args.http:
        run_http(cfg, args)
    elif args.dp > 1:
        run_router(cfg, args)
    else:
        run_engine(cfg, args)


if __name__ == "__main__":
    main()
