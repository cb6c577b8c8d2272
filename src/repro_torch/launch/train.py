"""Training driver (port of ``repro.launch.train``) on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4_9b --smoke \
      --device cpu --steps 20 --batch 4 --seq 32

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
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.checkpoint.elastic import save_global
from repro_torch.config import OptimizerConfig, ParallelConfig, get_config
from repro_torch.data.pipeline import Pipeline, ShardedSource
from repro_torch.models import api
from repro_torch.optim import optimizers as opt
from repro_torch.spmd import steps as steps_mod


def build_state(cfg, ocfg, device, seed=0):
    """(bf16 working params, optimizer state with the fp32 masters), the
    masters drawn from ``seed`` on ``device``."""
    master = api.init_model(cfg, seed, device, dtype=torch.float32)
    state = opt.init_train_state(ocfg, master)
    return opt.working_params(state), state


def _restore(mgr, params, opt_state) -> int:
    """Copy the latest checkpoint's {"params", "opt"} into the live
    tensors in place (no second device copy of the state). Returns its
    step."""
    live = {"params": params, "opt": opt_state}
    start, host = mgr.restore(live)
    with torch.no_grad():
        for a, b in zip(opt.tree_leaves(live), opt.tree_leaves(host)):
            a.copy_(b)
    return start


def train(cfg, *, steps, batch, seq, pcfg=None, ocfg=None, device="cuda",
          seed=0, log_every=10, on_step=None, grad_hook=None, ckpt_dir=None,
          ckpt_every=50, resume=False):
    """Train ``cfg`` from a seeded init up to step ``steps`` in steps of
    ``batch`` sequences of ``seq`` tokens. With ``ckpt_dir``: a
    ``CheckpointManager(keep=2, keep_best=1)`` there saves {"params",
    "opt"} every ``ckpt_every`` steps, the mean of the last ten losses as
    its metric, and with ``resume`` the run starts from its latest step
    (the data stream from batch 0, as in the JAX package). Instrumentation,
    off by default: ``on_step(step, metrics, seconds)`` runs after every
    step (``seconds`` is the step's wall time, up to its loss on the
    host), and ``grad_hook(grads)`` sees every step's gradients before
    clipping. Returns (params, opt_state, losses of this run's steps)."""
    pcfg = pcfg or ParallelConfig(remat="full", microbatches=1)
    ocfg = ocfg or OptimizerConfig(lr=1e-3, warmup_steps=20,
                                   total_steps=steps)
    step_fn = steps_mod.make_train_step(cfg, pcfg, ocfg)
    params, opt_state = build_state(cfg, ocfg, device, seed)
    mgr = (CheckpointManager(ckpt_dir, keep=2, keep_best=1) if ckpt_dir
           else None)
    start = 0
    if resume and mgr and mgr.latest_step() is not None:
        start = _restore(mgr, params, opt_state)
        print(f"[train] resumed from step {start}", flush=True)
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
                print(f"[train] step {s+1} loss={losses[-1]:.4f} "
                      f"gnorm={float(metr['grad_norm']):.3f} "
                      f"{dt*1e3:.0f} ms/step {batch * seq / dt:.0f} tok/s",
                      flush=True)
                t_log = time.time()
            if mgr and (s + 1) % ckpt_every == 0:
                save_global(mgr, s + 1, {"params": params, "opt": opt_state},
                            metric=float(np.mean(losses[-10:])))
    finally:
        pipe.close()
        if mgr:
            mgr.wait()
    return params, opt_state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4_9b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    pcfg = ParallelConfig(remat="full", microbatches=args.microbatches)
    _, _, losses = train(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, pcfg=pcfg, device=args.device,
                         ckpt_dir=args.ckpt, resume=args.resume)
    if not losses:
        print("[train] done. no steps left to run")
        return
    print(f"[train] done. loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
