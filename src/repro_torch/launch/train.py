"""Training driver (port of ``repro.launch.train``), on one device or on
a ("data", "model") mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4_9b --smoke \
      --device cpu --steps 20 --batch 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4_9b --smoke \
      --device cpu --mesh data=2,model=2 --steps 3 --ckpt /tmp/ck

``--mesh data=A,model=B`` spawns A x B processes (``torch.distributed``:
gloo on the CPU or with several ranks on one card, NCCL with a card a
rank; a file rendezvous in a temporary directory) and fails if any rank
does. Each rank holds its shards of the working params, masters and
slots (``spmd.steps.train_layouts``: tensor parallel over "model" for
the dense decoders, ZeRO-1 over "data"), draws the same global batch
from the seed and keeps its rows. Rank 0 logs and writes the checkpoints
(``checkpoint.elastic.save_global`` gathers the global tree); ``--resume``
restores the latest one at any mesh shape (``restore_for_mesh``).

The queue-fed data pipeline feeds the mixed-precision train step (fp32
masters and slots in the optimizer state, bf16 working params, optional
microbatching, layer remat), with periodic checkpoints and retention
(``--ckpt DIR``) and crash-resume (``--resume``). On the card attention
runs through the flash kernel, the SSD scan through its kernel and the
embedding gather through its kernel. As in the JAX package, a resumed run
restores the parameters and optimizer state and starts the data stream
again at batch 0.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.checkpoint.elastic import restore_for_mesh, save_global
from repro_torch.config import OptimizerConfig, ParallelConfig, get_config
from repro_torch.launch.mesh import parse_mesh
from repro_torch.data.pipeline import Pipeline, ShardedSource
from repro_torch.models import api
from repro_torch.optim import optimizers as opt
from repro_torch.spmd import steps as steps_mod


def build_state(cfg, ocfg, device, seed=0, mesh=None, pcfg=None):
    """(bf16 working params, optimizer state with the fp32 masters), the
    masters drawn from ``seed`` on ``device``. On a ``mesh`` every rank
    draws the global masters and keeps its shards
    (``spmd.steps.train_layouts`` for ``pcfg``): the same values as one
    device's."""
    master = api.init_model(cfg, seed, device, dtype=torch.float32)
    if mesh is None:
        state = opt.init_train_state(ocfg, master)
        return opt.working_params(state), state
    lay = steps_mod.train_layouts(cfg, pcfg, ocfg, mesh)
    params = opt.tree_map(
        lambda p: p.to(torch.bfloat16).requires_grad_(),
        steps_mod.shard_state(master, lay["params"], mesh))
    masters = steps_mod.shard_state(master, lay["opt"]["master"], mesh)
    del master
    return params, opt.init_train_state(ocfg, masters)


def _restore(mgr, params, opt_state, mesh=None, layouts=None) -> int:
    """Copy the latest checkpoint's {"params", "opt"} into the live
    tensors in place (no second device copy of the state; on a mesh this
    rank's shards). Returns its step."""
    live = {"params": params, "opt": opt_state}
    if mesh is None:
        start, host = mgr.restore(live)
    else:
        start, host = restore_for_mesh(mgr, live, mesh, layouts, "cpu")
    with torch.no_grad():
        for a, b in zip(opt.tree_leaves(live), opt.tree_leaves(host)):
            a.copy_(b)
    return start


def train(cfg, *, steps, batch, seq, pcfg=None, ocfg=None, device="cuda",
          seed=0, log_every=10, on_step=None, grad_hook=None, ckpt_dir=None,
          ckpt_every=50, resume=False, mesh=None):
    """Train ``cfg`` from a seeded init up to step ``steps`` in steps of
    ``batch`` sequences of ``seq`` tokens. With ``ckpt_dir``: a
    ``CheckpointManager(keep=2, keep_best=1)`` there saves {"params",
    "opt"} every ``ckpt_every`` steps, the mean of the last ten losses as
    its metric, and with ``resume`` the run starts from its latest step
    (the data stream from batch 0, as in the JAX package). Instrumentation,
    off by default: ``on_step(step, metrics, seconds)`` runs after every
    step (``seconds`` is the step's wall time, up to its loss on the
    host), and ``grad_hook(grads)`` sees every step's gradients before
    clipping. With ``mesh`` every rank of it calls ``train`` (its shards,
    ``batch`` the global batch); rank 0 logs and saves. Returns (params,
    opt_state, losses of this run's steps)."""
    pcfg = pcfg or ParallelConfig(remat="full", microbatches=1)
    ocfg = ocfg or OptimizerConfig(lr=1e-3, warmup_steps=20,
                                   total_steps=steps)
    step_fn = steps_mod.make_train_step(cfg, pcfg, ocfg, mesh)
    params, opt_state = build_state(cfg, ocfg, device, seed, mesh, pcfg)
    layouts = (steps_mod.train_layouts(cfg, pcfg, ocfg, mesh)
               if mesh is not None else None)
    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    mgr = (CheckpointManager(ckpt_dir, keep=2, keep_best=1) if ckpt_dir
           else None)
    start = 0
    if resume and mgr and mgr.latest_step() is not None:
        start = _restore(mgr, params, opt_state, mesh, layouts)
        say(f"[train] resumed from step {start}", flush=True)
    pipe = Pipeline(ShardedSource(cfg, seq, seed=seed), batch, capacity=4)
    losses, t_log = [], time.time()
    try:
        for s in range(start, steps):
            hostb = pipe.get()
            t0 = time.time()
            b = {k: torch.from_numpy(v).to(device) for k, v in hostb.items()}
            params, opt_state, metr = step_fn(params, opt_state, s, b,
                                              grad_hook=grad_hook)
            losses.append(float(metr["loss"]))
            if on_step is not None:
                on_step(s, metr, time.time() - t0)
            if (s + 1) % log_every == 0:
                dt = (time.time() - t_log) / log_every
                say(f"[train] step {s+1} loss={losses[-1]:.4f} "
                      f"gnorm={float(metr['grad_norm']):.3f} "
                      f"{dt*1e3:.0f} ms/step {batch * seq / dt:.0f} tok/s",
                      flush=True)
                t_log = time.time()
            if mgr and (s + 1) % ckpt_every == 0:
                save_global(mgr if lead else None, s + 1,
                            {"params": params, "opt": opt_state},
                            metric=float(np.mean(losses[-10:])), mesh=mesh,
                            layouts=layouts)
    finally:
        pipe.close()
        if mgr:
            mgr.wait()
    return params, opt_state, losses


def run(args, mesh=None, lead=True, **train_kw):
    """Train as the parsed CLI ``args`` say, on one device or as this rank
    of ``mesh`` (rank 0, ``lead``, prints the summary); ``train_kw`` go to
    ``train`` (``ckpt_every``, ``log_every``)."""
    cfg = get_config(args.arch, smoke=args.smoke)
    pcfg = ParallelConfig(remat="full", microbatches=args.microbatches)
    _, _, losses = train(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, pcfg=pcfg, device=args.device,
                         ckpt_dir=args.ckpt, resume=args.resume, mesh=mesh,
                         **train_kw)
    if not lead:
        return
    if not losses:
        print("[train] done. no steps left to run")
        return
    print(f"[train] done. loss {losses[0]:.4f} -> {losses[-1]:.4f}")


def _mesh_rank(rank, args, init_method, train_kw):
    """One rank of ``--mesh``: join the group, build the mesh, train."""
    from repro_torch.launch.mesh import init_rank, make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, model = parse_mesh(args.mesh)
    dev_type = torch.device(args.device).type
    if dev_type == "cpu":            # the ranks share the host's cores
        torch.set_num_threads(max(1, os.cpu_count() // (data * model)))
    backend = init_rank(rank, data * model, init_method, dev_type)
    mesh = make_host_mesh(data, model, dev_type)
    if rank == 0:
        print(f"[train] mesh data={data},model={model}: {data * model} ranks "
              f"over {backend}", flush=True)
    run(args, mesh, rank == 0, **train_kw)
    torch.distributed.destroy_process_group()


def run_mesh(args, **train_kw):
    """``--mesh``: spawn the A x B ranks (each ``run``s ``args`` with
    ``train_kw``), wait for every one; fails if any rank does."""
    import tempfile
    from pathlib import Path

    import torch.multiprocessing as mp
    data, model = parse_mesh(args.mesh)
    if torch.device(args.device).type == "cuda":
        from repro_torch.kernels import build
        build.build_all()            # once, before the ranks load it
    init = "file://" + str(Path(tempfile.mkdtemp(prefix="mesh_"))
                           / "rendezvous")
    mp.start_processes(_mesh_rank, args=(args, init, train_kw),
                       nprocs=data * model, join=True, start_method="spawn")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4_9b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="data=A,model=B: spawn A x B ranks")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    return ap.parse_args(argv)


def main():
    args = parse_args()
    if args.mesh and parse_mesh(args.mesh) != (1, 1):
        run_mesh(args)
    else:
        run(args)


if __name__ == "__main__":
    main()
