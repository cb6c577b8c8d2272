"""Checkpointing in the port (``repro_torch.checkpoint``) on the CPU.

Ports of ``tests/test_checkpoint_data.py``'s checkpoint tests (roundtrip,
retention of the last k, keep-best, async save then restore) over torch
tensors; the format against the JAX package's ``CheckpointManager`` both
ways, bit for bit, bf16 leaves included (stored as their uint16 view);
``save`` copies to the host before it returns; ``restore_to`` places a
tree on a device with its dtypes. And the trainer: a port of
``tests/test_system.py``'s trainer test (learns, checkpoints, resumes)
at fewer steps, and the CLI with ``--ckpt`` / ``--resume`` on
``--device cpu``."""

import json
import sys

import ml_dtypes
import numpy as np
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JaxManager
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.checkpoint.elastic import restore_to, save_global
from repro_torch.config import OptimizerConfig, ParallelConfig, get_config
from repro_torch.launch.train import train
from repro_torch.optim import optimizers as topt
import torch_cpu  # noqa: F401  (one torch thread)


def _state(v):
    return {"params": {"w": torch.full((4, 2), v),
                       "b": torch.arange(3).float() * v},
            "opt": ({"m": torch.ones(2) * v},)}


def _mixed(seed):
    """A tree with bf16, fp32 and int32 leaves, in a list and a dict."""
    rng = np.random.default_rng(seed)
    return {"layers": [{"w": torch.from_numpy(rng.normal(0, 1, (5, 3))
                                              .astype(np.float32))
                        .to(torch.bfloat16)},
                       {"w": torch.from_numpy(rng.normal(0, 1, (2, 7))
                                              .astype(np.float32))}],
            "step": torch.tensor([seed, 7], dtype=torch.int32)}


def _equal_trees(a, b):
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(10, _state(3.0), metric=1.0)
    step, restored = mgr.restore(_state(0.0))
    assert step == 10
    _equal_trees(restored, _state(3.0))
    assert isinstance(restored["opt"], tuple)


def test_retention_keeps_last_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in range(5):
        mgr.save(s, _state(float(s)))
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4


def test_retention_keeps_best_metric(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1, keep_best=1, async_save=False)
    for s, m in {0: 5.0, 1: 1.0, 2: 3.0, 3: 2.0}.items():
        mgr.save(s, _state(float(s)), metric=m)
    assert set(mgr.steps()) == {1, 3}
    assert json.loads((tmp_path / "scores.json").read_text())["1"] == 1.0


def test_async_save_copies_before_returning(tmp_path):
    """An async save has taken its host copy when it returns: a leaf
    updated in place afterwards does not reach the files; restore waits
    for the writer."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    state = _state(9.0)
    mgr.save(7, state)
    state["params"]["b"].add_(100.0)
    step, restored = mgr.restore(_state(0.0))
    assert step == 7
    _equal_trees(restored, _state(9.0))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """Written by the JAX package's manager (numpy, ml_dtypes bf16),
    read by the port's: the same bits and dtypes."""
    tree = _mixed(1)
    host = {"layers": [{"w": tree["layers"][0]["w"].view(torch.int16)
                        .numpy().view(ml_dtypes.bfloat16)},
                       {"w": tree["layers"][1]["w"].numpy()}],
            "step": tree["step"].numpy()}
    JaxManager(tmp_path, async_save=False).save(3, host, metric=0.5)
    step, got = CheckpointManager(tmp_path).restore(_mixed(0))
    assert step == 3
    _equal_trees(got, tree)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """Written by the port's manager, read by the JAX package's: bf16
    comes back as ml_dtypes bf16 with the same bits, the rest as numpy of
    the same dtype and values; the manifests name the same dtypes."""
    tree = _mixed(2)
    save_global(CheckpointManager(tmp_path, async_save=False), 5, tree)
    step, got = JaxManager(tmp_path).restore(
        {"layers": [{"w": 0}, {"w": 0}], "step": 0})
    assert step == 5
    assert got["layers"][0]["w"].dtype == ml_dtypes.bfloat16
    assert got["layers"][0]["w"].view(np.uint16).tobytes() == \
        tree["layers"][0]["w"].view(torch.int16).numpy().tobytes()
    assert got["layers"][1]["w"].dtype == np.float32
    np.testing.assert_array_equal(got["layers"][1]["w"],
                                  tree["layers"][1]["w"].numpy())
    assert got["step"].dtype == np.int32
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json")
                          .read_text())
    assert {k: v["dtype"] for k, v in manifest["leaves"].items()} == {
        "layers/0/w": "bfloat16", "layers/1/w": "float32",
        "step": "int32"}


def test_restore_to_places_the_tree(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, _mixed(4))
    mgr.save(2, _mixed(5))
    step, got = restore_to(mgr, _mixed(0), "cpu", step=1)
    assert step == 1
    _equal_trees(got, _mixed(4))
    assert restore_to(mgr, _mixed(0), torch.device("cpu"))[0] == 2


def test_trainer_learns_and_resumes(tmp_path):
    """4 steps with a checkpoint every 2 (keep 2, keep-best 1), then a
    resumed run to step 6: it starts at step 4 from the saved state (the
    checkpoint equals the run's final state bit for bit) and its losses
    stay below the first run's first ones."""
    cfg = get_config("glm4_9b", smoke=True)
    pcfg = ParallelConfig(remat="full", microbatches=2)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=16)
    kw = dict(batch=4, seq=32, device="cpu", pcfg=pcfg, ocfg=ocfg,
              ckpt_dir=tmp_path, ckpt_every=2, log_every=100)
    params, state, losses = train(cfg, steps=4, **kw)
    assert len(losses) == 4 and np.isfinite(losses).all()
    mgr = CheckpointManager(tmp_path)
    assert mgr.steps() == [2, 4]
    _, saved = mgr.restore({"params": params, "opt": state}, 4)
    _equal_trees(saved, {"params": params, "opt": state})
    meta = json.loads((tmp_path / "step_00000004" / "manifest.json")
                      .read_text())
    assert meta["metric"] == float(np.mean(losses[-10:]))
    _, _, losses2 = train(cfg, steps=6, resume=True, **kw)
    assert len(losses2) == 2 and np.isfinite(losses2).all()
    assert np.mean(losses2) < np.mean(losses[:2])
    assert CheckpointManager(tmp_path).latest_step() == 6


def test_cli_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --ckpt DIR`` (a checkpoint
    every ``ckpt_every`` steps: 50, as the JAX package's CLI, here patched
    to 4 to keep the run short), then the same with ``--resume``: the
    second run starts at the first one's checkpoint and runs the
    remaining steps."""
    from repro_torch.launch import train as cli
    assert cli.train.__kwdefaults__["ckpt_every"] == 50
    monkeypatch.setitem(cli.train.__kwdefaults__, "ckpt_every", 4)

    def run(*extra):
        monkeypatch.setattr(sys, "argv", [
            "train", "--arch", "glm4_9b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "8", "--ckpt", str(tmp_path), *extra])
        cli.main()
        return capsys.readouterr().out
    run("--steps", "4")
    assert CheckpointManager(tmp_path).steps() == [4]
    out = run("--steps", "6", "--resume")
    assert "[train] resumed from step 4" in out
    assert "[train] done." in out
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 4 and mgr.steps() == [4]
