"""Rules of the PyTorch port: ``repro_torch`` imports neither jax nor
``repro``, and its configs equal the JAX package's field for field."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.config import get_config as jax_get_config
from repro_torch.config import ARCHS, ModelConfig, get_config
import torch_cpu  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro")
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_without_jax_or_repro():
    """Every module of the package imports in a fresh interpreter (the
    test process already holds jax, via conftest) without pulling in jax
    or the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 42, r.stdout


# the tensor-parallel slice's modules (torch.distributed, no jax): each
# alone in a fresh interpreter
TP_MODULES = ("repro_torch.spmd.sharding", "repro_torch.spmd.collectives",
              "repro_torch.launch.mesh")
IMPORT_ONE = """
import sys
import {name}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro")
assert not bad, bad
"""


@pytest.mark.parametrize("name", TP_MODULES)
def test_tp_modules_import_without_jax_or_repro(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", IMPORT_ONE.format(name=name)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_imports_repro():
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)\b(?!_torch)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert not offenders, offenders


# the glm4_9b cases keep their first ids
CONFIG_CASES = [("glm4_9b", False), ("glm4_9b", True),
                ("mamba2_370m", False), ("mamba2_370m", True),
                ("zamba2_2p7b", False), ("zamba2_2p7b", True),
                ("qwen3_32b", False), ("qwen3_32b", True),
                ("starcoder2_3b", False), ("starcoder2_3b", True),
                ("gemma2_27b", False), ("gemma2_27b", True),
                ("qwen3_moe_30b_a3b", False), ("qwen3_moe_30b_a3b", True),
                ("grok1_314b", False), ("grok1_314b", True),
                ("whisper_large_v3", False), ("whisper_large_v3", True),
                ("qwen2_vl_2b", False), ("qwen2_vl_2b", True)]


@pytest.mark.parametrize(
    "arch,smoke", CONFIG_CASES,
    ids=["False", "True"] + [f"{a}-{s}" for a, s in CONFIG_CASES[2:]])
def test_glm4_config_equals_reference_field_for_field(arch, smoke):
    """Every ported arch's config, field for field (the MoE and SSM
    sub-configs too: same dataclass fields and values in both packages),
    and its parameter counts."""
    ours = get_config(arch, smoke=smoke)
    ref = jax_get_config(arch, smoke=smoke)
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    assert names == [f.name for f in dataclasses.fields(type(ref))]
    for name in names:
        a, b = getattr(ours, name), getattr(ref, name)
        if dataclasses.is_dataclass(b):
            assert [f.name for f in dataclasses.fields(a)] == \
                [f.name for f in dataclasses.fields(b)], name
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, name
    if ref.ssm is not None:
        assert ours.ssm.d_inner(ours.d_model) == ref.ssm.d_inner(ref.d_model)
        assert ours.ssm.n_heads(ours.d_model) == ref.ssm.n_heads(ref.d_model)
    assert ours.padded_vocab_size == ref.padded_vocab_size
    assert ours.layer_kinds() == ref.layer_kinds()
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()


def test_unported_arch_is_refused_by_name():
    """Every arch the JAX package knows resolves in the port (full and
    smoke); an unknown one is refused by name; the dashed aliases
    resolve."""
    for arch in ARCHS:
        for smoke in (False, True):
            assert get_config(arch, smoke=smoke).name == \
                jax_get_config(arch, smoke=smoke).name
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no_such_model")
    assert get_config("glm4-9b") == get_config("glm4_9b")
    assert get_config("grok-1-314b") == get_config("grok1_314b")
    assert get_config("whisper-large-v3", smoke=True) == \
        get_config("whisper_large_v3", smoke=True)
