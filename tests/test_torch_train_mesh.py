"""Multi-rank training on torch.distributed (``spmd.steps.make_train_step``
with a mesh: data parallel with ZeRO-1, tensor-parallel dense decoders
with the vocab-parallel embedding and loss), ``restore_for_mesh``, and
the int8 error-feedback all-reduce (``spmd.compression``).

Three gloo worlds of spawned CPU processes (the rendezvous a file in the
test's tmp dir), one per mesh shape, each running every case of its
shape once: ("data", "model") = (2, 1), (1, 2) and (2, 2). Each case
trains a smoke config from the seeded init for ``STEPS`` steps on the
same global batches (every rank keeps its rows) and returns the metrics,
its rank's working params and the global tree gathered from every
rank's shards. The test process runs the same cases on one device.

The ladder (``close_run``; the port's training tests'): with bf16
activations the losses within 1e-2 of one device's and the first step's
grad norm within 1e-2 relative; with fp32 activations (``_fp32`` cases,
SGD) the first step's loss within 1e-5, and every master within 1e-2 of
the largest update and of its own leaf's (the sums run in other orders:
row-parallel partial sums, the vocab-parallel stitch, the gradient
average over bf16 gradients). ZeRO-1 on and off give the same bits;
leaves no rank shards are the same bits on every rank.

The JAX package runs in one subprocess on 4 host devices (as
``helpers.run_with_devices`` runs it, beside the gloo worlds):
``compressed_psum_mean`` under ``shard_map`` on the inputs the 4 ranks
use; the MoE smoke loss at
data=2 (each data shard routes its own tokens; the port's data ranks do
the same); and ``make_train_step`` on the dense fp32 cases at the mesh
shapes the port runs them (data=2, model=2, data=2 x model=2), on the
port's seeded masters and batches.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_cpu  # noqa: F401  (one torch thread)

B, S, STEPS = 4, 16, 3
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SGD = dict(name="sgd", lr=0.5, warmup_steps=0, schedule="constant")
DENSE = ("glm4_9b", "gemma2_27b", "starcoder2_3b")
# qk-norm scales applied to each rank's heads only (their gradients summed
# over "model"): qwen3, at model=2
QK_NORM = ("qwen3_32b",)
# not dense: tensor-parallel training refused by name
OTHERS = ("qwen3_moe_30b_a3b", "mamba2_370m", "zamba2_2p7b",
          "whisper_large_v3", "qwen2_vl_2b")
JOIN_TIMEOUT_S = 300
EF_STEPS = 20


def _cfg(name):
    """A case's config: an arch's smoke config, "_fp32" at fp32
    activations; "seq" is glm4's with 3 query heads and 1 kv head (the
    model axis divides neither: the sequence-split fallback), "heads"
    qwen3's (qk-norm) with its 8 query heads and 1 kv head (it divides H
    only)."""
    from repro_torch.config import get_config
    arch, _, dtype = name.partition("_fp32")
    change = {"dtype": "float32" if name.endswith("_fp32") else "bfloat16"}
    if arch == "seq":
        arch = "glm4_9b"
        change.update(num_heads=3, num_kv_heads=1)
    elif arch == "heads":
        arch = "qwen3_32b"
        change.update(num_kv_heads=1)
    return dataclasses.replace(get_config(arch, smoke=True), **change)


def _opt(name):
    return SGD if name.endswith("_fp32") else ADAMW


def run_case(name, mesh=None, zero1=True, steps=STEPS, ckpt=None):
    """``steps`` steps of case ``name`` from the seeded init (seed 0) on
    global batches ``make_batch`` seeds 0, 1, ...: losses, grad norms,
    this rank's working params, and the global {"params", "opt"} tree
    (gathered from every rank on a mesh). With ``ckpt`` the mesh's state
    is also saved there (``save_global``) after the last step."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.checkpoint.elastic import save_global
    from repro_torch.config import (OptimizerConfig, ParallelConfig,
                                    ShapeConfig)
    from repro_torch.launch.train import build_state
    from repro_torch.models import api
    from repro_torch.spmd import steps as tsteps
    cfg = _cfg(name)
    pcfg = ParallelConfig(remat="full", zero1=zero1)
    ocfg = OptimizerConfig(**_opt(name))
    params, state = build_state(cfg, ocfg, "cpu", 0, mesh, pcfg)
    step = tsteps.make_train_step(cfg, pcfg, ocfg, mesh)
    out = {"loss": [], "gnorm": []}
    for i in range(steps):
        batch = api.make_batch(cfg, ShapeConfig("t", S, B, "train"), i, "cpu")
        params, state, m = step(params, state, i, batch)
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["grad_norm"]))
    tree = {"params": params, "opt": state}
    out["local"] = _detach(params)
    if mesh is not None:
        lay = tsteps.train_layouts(cfg, pcfg, ocfg, mesh)
        tree = tsteps.gather_state(tree, lay, mesh)
        if ckpt is not None:
            import torch.distributed as dist
            mgr = (CheckpointManager(ckpt, keep=1) if dist.get_rank() == 0
                   else None)
            save_global(mgr, steps, {"params": params, "opt": state},
                        mesh=mesh, layouts=lay)
            if mgr is not None:
                mgr.wait()
    out["global"] = _detach(tree)
    return out


def _detach(tree):
    from repro_torch.optim.optimizers import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def _leaves(tree):
    from repro_torch.optim.optimizers import tree_leaves
    return tree_leaves(tree)


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _same_bits(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


# -- the worlds' jobs ---------------------------------------------------------


def _compression(group):
    """``compressed_psum_mean`` over ``group`` (4 ranks) on the JAX test's
    inputs, and the 20-step error-feedback drift."""
    from repro_torch.spmd.compression import (compressed_psum_mean,
                                              init_error_state)
    g = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (4, 37))
                         .astype(np.float32))
    mine = g[group.rank].clone()
    out, err = compressed_psum_mean(mine, init_error_state(mine), group)
    applied, e = torch.zeros(37), init_error_state(mine)
    for _ in range(EF_STEPS):
        o, e = compressed_psum_mean(mine, e, group)
        applied += o
    return {"out": out, "err": err, "applied": applied / EF_STEPS,
            "true": g.mean(0)}


def _shard_roundtrip(mesh):
    """Random bits (NaN payloads included) in every leaf of glm4's global
    state, cut and gathered back: byte-equal."""
    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.models import api
    from repro_torch.spmd import sharding as shd
    from repro_torch.spmd import steps as tsteps
    cfg = _cfg("glm4_9b")
    lay = tsteps.train_layouts(cfg, ParallelConfig(), OptimizerConfig(), mesh)
    gen = torch.Generator().manual_seed(5)
    shapes = api.param_shapes(cfg)

    def rand(shp, dtype):
        n = torch.Size(shp).numel() * dtype.itemsize
        raw = torch.randint(0, 256, (n,), dtype=torch.uint8, generator=gen)
        return raw.view(dtype).view(shp)

    def fill(dtype):
        return shd.map_specs(lambda s, _: rand(s, dtype), shapes, shapes)

    glob = {"params": fill(torch.bfloat16),
            "opt": {k: fill(torch.float32) for k in lay["opt"]}}
    back = tsteps.gather_state(tsteps.shard_state(glob, lay, mesh), lay, mesh)
    return _same_bits(glob, back)


def _restore(mesh, ckpt):
    """``restore_for_mesh`` of the data=2 checkpoint on this mesh: every
    shard against the cut of the global tree, then one more step."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.checkpoint.elastic import restore_for_mesh
    from repro_torch.config import (OptimizerConfig, ParallelConfig,
                                    ShapeConfig)
    from repro_torch.launch.train import build_state
    from repro_torch.models import api
    from repro_torch.spmd import steps as tsteps
    cfg = _cfg("glm4_9b")
    pcfg, ocfg = ParallelConfig(remat="full"), OptimizerConfig(**ADAMW)
    mgr = CheckpointManager(ckpt, keep=1)
    params, state = build_state(cfg, ocfg, "cpu", 1, mesh, pcfg)
    live = {"params": params, "opt": state}
    lay = tsteps.train_layouts(cfg, pcfg, ocfg, mesh)
    step_no, got = restore_for_mesh(mgr, live, mesh, lay, "cpu")
    _, whole = mgr.restore(live)
    exact = _same_bits(got, tsteps.shard_state(whole, lay, mesh))
    params, state = got["params"], got["opt"]
    from repro_torch.optim.optimizers import tree_map
    params = tree_map(lambda p: p.requires_grad_(), params)
    step = tsteps.make_train_step(cfg, pcfg, ocfg, mesh)
    batch = api.make_batch(cfg, ShapeConfig("t", S, B, "train"), step_no,
                           "cpu")
    _, state, m = step(params, state, step_no, batch)
    return {"step": step_no, "exact": exact, "loss": float(m["loss"]),
            "global": _detach(tsteps.gather_state(
                {"params": params, "opt": state}, lay, mesh))}


def _refusals(mesh):
    from repro_torch.config import (OptimizerConfig, ParallelConfig,
                                    get_config)
    from repro_torch.spmd import steps as tsteps
    out = {}
    for arch in OTHERS:
        try:
            tsteps.make_train_step(get_config(arch, smoke=True),
                                   ParallelConfig(), OptimizerConfig(), mesh)
            out[arch] = None
        except NotImplementedError as e:
            out[arch] = str(e)
    return out


def _grad_average(mesh):
    """glm4's bf16 gradients at the seeded init of each data rank's rows,
    averaged over "data" in fp32 (the trainer's) and rounded to bf16
    after the sum (a bf16 all-reduce of two ranks)."""
    from repro_torch.config import (OptimizerConfig, ParallelConfig,
                                    ShapeConfig)
    from repro_torch.launch.train import build_state
    from repro_torch.models import api
    from repro_torch.spmd import collectives
    from repro_torch.spmd import steps as tsteps
    cfg = _cfg("glm4_9b")
    pcfg = ParallelConfig(remat="none", zero1=False)
    params, _ = build_state(cfg, OptimizerConfig(), "cpu", 0, mesh, pcfg)
    batch = tsteps.batch_rows(api.make_batch(
        cfg, ShapeConfig("t", S, B, "train"), 0, "cpu"), mesh)
    loss, _ = api.loss_fn(params, batch, cfg, pcfg)
    grads = torch.autograd.grad(loss, _leaves(params))
    dg = collectives.train_mesh(mesh).data
    return {dt: [dg.all_reduce(g, mean=True, dtype=getattr(torch, dt))
                 for g in grads] for dt in ("float32", "bfloat16")}


def _jobs_data2(mesh, d):
    res = {"grad_average": _grad_average(mesh),
           "glm4_9b": run_case("glm4_9b", mesh, ckpt=str(d / "ckpt")),
           "glm4_9b_zero_off": run_case("glm4_9b", mesh, zero1=False),
           "glm4_9b_fp32": run_case("glm4_9b_fp32", mesh),
           "moe": run_case("qwen3_moe_30b_a3b", mesh, steps=1)}
    return res


def _jobs_model2(mesh, d):
    res = {name: run_case(name, mesh)
           for arch in DENSE + QK_NORM for name in (arch, arch + "_fp32")}
    for name in ("seq", "heads", "seq_fp32", "heads_fp32"):
        res[name] = run_case(name, mesh)
    res["restore"] = _restore(mesh, str(d / "ckpt"))
    res["refusals"] = _refusals(mesh)
    return res


def _jobs_dm4(mesh, d):
    import torch.distributed as dist
    from repro_torch.spmd.collectives import ModelGroup
    res = {name: run_case(name, mesh)
           for arch in DENSE for name in (arch, arch + "_fp32")}
    res["roundtrip"] = _shard_roundtrip(mesh)
    res["compression"] = _compression(ModelGroup(dist.group.WORLD))
    return res


JOBS = {(2, 1): _jobs_data2, (1, 2): _jobs_model2, (2, 2): _jobs_dm4}


def _rank(rank, shape, init_method, out_dir):
    import pathlib

    import torch.distributed as dist
    from repro_torch.launch.mesh import init_rank, make_host_mesh
    torch.set_num_threads(1)
    world = shape[0] * shape[1]
    init_rank(rank, world, init_method, "cpu", timeout_s=120)
    mesh = make_host_mesh(*shape, "cpu")
    res = JOBS[shape](mesh, pathlib.Path(out_dir))
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(shape, d):
    """Every rank's results of ``shape``'s world, run in ``d``; fails
    unless every rank exits 0 within the join timeout."""
    world = shape[0] * shape[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, shape,
                                             f"file://{d}/rdzv_{world}",
                                             str(d)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{shape}: ranks still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * world, \
        (shape, [p.exitcode for p in procs])
    out = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("train_mesh")


@pytest.fixture(scope="module")
def data2(tmp, jax_started):
    """The data=2 world (the JAX package's subprocess runs beside it)."""
    d = tmp / "data2"
    d.mkdir()
    return _spawn((2, 1), d)


@pytest.fixture(scope="module")
def model2(tmp, data2):
    d = tmp / "model2"
    d.mkdir()
    (d / "ckpt").symlink_to(tmp / "data2" / "ckpt")
    return _spawn((1, 2), d)


@pytest.fixture(scope="module")
def dm4(tmp):
    d = tmp / "dm4"
    d.mkdir()
    return _spawn((2, 2), d)


_ONE = {}


def one(name):
    """Case ``name`` on one device (cached)."""
    if name not in _ONE:
        _ONE[name] = run_case(name)
    return _ONE[name]


def close_run(got, want, name):
    """The ladder. bf16 activations (AdamW): every step's loss within 1e-2,
    the first step's grad norm within 1e-2 relative (the port's one-step
    rung; after it AdamW moves every element by about lr whatever its
    gradient's size, and a smoke model's later grad norms part by a few
    percent of rounding). fp32 activations (SGD): the first step's loss
    within 1e-5 and grad norm within 1e-4 relative (the same params: only
    the sums' order differs), every step's loss within 1e-3 and grad norm
    within 1e-2 relative, and after the last step every master within
    1e-2 of the largest update and each leaf within 1e-2 of its own
    update (L2 norms), so a small leaf (a norm or qk-norm scale) is held
    on its own. The working params and so the gradients are bf16: each
    data rank's gradient of its rows rounds otherwise than one device's
    of the whole batch, so the steps after the first part by up to 1.6e-4
    in the loss and 0.9% of the largest update in the masters (measured
    at data=2 and data=2 x model=2; model=2 alone 3e-6 and 0.2%; each
    leaf at most 0.75% of its own update)."""
    fp32 = name.endswith("_fp32")
    for a, b in zip(got["loss"], want["loss"]):
        assert abs(a - b) <= (1e-3 if fp32 else 1e-2), \
            (name, got["loss"], want["loss"])
    steps = len(want["gnorm"]) if fp32 else 1
    for a, b in zip(got["gnorm"][:steps], want["gnorm"][:steps]):
        assert abs(a - b) <= 1e-2 * b, (name, got["gnorm"], want["gnorm"])
    if not fp32:
        return
    assert abs(got["loss"][0] - want["loss"][0]) <= 1e-5, name
    assert abs(got["gnorm"][0] - want["gnorm"][0]) <= \
        1e-4 * want["gnorm"][0], name
    init = _leaves(run_case(name, steps=0)["global"]["opt"]["master"])
    ref = _leaves(want["global"]["opt"]["master"])
    mine = _leaves(got["global"]["opt"]["master"])
    upd = max(float((a - b).abs().max()) for a, b in zip(ref, init))
    gap = max(float((a - b).abs().max()) for a, b in zip(mine, ref))
    assert upd > 0 and gap <= 1e-2 * upd, (name, gap, upd)
    for i, (a, b, c) in enumerate(zip(mine, ref, init)):
        own = float((b - c).norm())
        assert own > 0 and float((a - b).norm()) <= 1e-2 * own, (name, i)


def replicated_same(results, name, mesh_shape):
    """The working params no rank shards on this mesh: the same bits on
    every rank; the rest differ only where the shards do."""
    from repro_torch.config import ParallelConfig
    from repro_torch.spmd import steps as tsteps
    lay = _leaves(tsteps.param_layouts(_cfg(name), ParallelConfig(),
                                       {"data": mesh_shape[0],
                                        "model": mesh_shape[1]}))
    n_rep = 0
    for i, la in enumerate(lay):
        if any(e is not None for e in la.spec):
            continue
        n_rep += 1
        first = _leaves(results[0][name]["local"])[i]
        for r in results[1:]:
            assert torch.equal(_bits(_leaves(r[name]["local"])[i]),
                               _bits(first)), (name, i)
    assert n_rep > 0


# -- logical specs and placement vs the JAX package ---------------------------


ARCHS = ("glm4_9b", "starcoder2_3b", "gemma2_27b", "qwen3_32b",
         "whisper_large_v3", "zamba2_2p7b", "qwen2_vl_2b",
         "qwen3_moe_30b_a3b", "grok1_314b", "mamba2_370m")


def _jax_specs_port_layout(arch):
    """The JAX package's logical specs of ``arch`` (smoke), in the port's
    tree layout: each layer's specs without the leading "layers" axis."""
    from repro.config import get_config as jget
    from repro.models import api as japi
    from repro_torch.config import get_config
    from repro_torch.models.transformer import period_structure
    cfg = get_config(arch, smoke=True)
    _, js = japi.abstract_params(jget(arch, smoke=True))

    def strip(t):
        if isinstance(t, dict):
            return {k: strip(v) for k, v in t.items()}
        assert t[0] == "layers", t
        return tuple(t[1:])
    out = {k: v for k, v in js.items()
           if k not in ("blocks", "encoder", "decoder")}
    if cfg.encoder_layers:
        out["encoder"] = [strip(js["encoder"])] * cfg.encoder_layers
        out["decoder"] = [strip(js["decoder"])] * cfg.num_layers
    else:
        P = len(period_structure(cfg)[0])
        out["layers"] = [strip(js["blocks"][f"sub{i % P}"])
                         for i in range(cfg.num_layers)]
    return out


def _spec_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _spec_items(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _spec_items(v, f"{prefix}/{i}")]
    return [(prefix, tuple(tree))]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch):
    """``param_specs`` is the JAX package's specs, tuple for tuple, in the
    port's layout; ``param_shapes`` is ``init_model``'s shapes."""
    from repro_torch.config import get_config
    from repro_torch.models import api
    cfg = get_config(arch, smoke=True)
    assert _spec_items(api.param_specs(cfg)) == _spec_items(
        _jax_specs_port_layout(arch))
    shapes = dict(_spec_items(api.param_shapes(cfg)))
    params = api.init_model(cfg, 0, "cpu", torch.float32)
    from repro_torch.optim.optimizers import tree_map
    got = dict(_spec_items(tree_map(lambda t: tuple(t.shape), params)))
    assert got == shapes


MESHES = ((2, 1), (1, 2), (2, 2), (4, 2), (1, 4))


def test_zero1_and_resolve_spec_agree_with_jax():
    """``resolve_spec`` (through ``tree_pspecs``) and ``zero1_leaf_spec``
    on every leaf of every arch at five mesh shapes: the JAX package's
    specs, on an abstract mesh."""
    import jax
    from jax.sharding import AbstractMesh
    from repro.config import ParallelConfig as JPar
    from repro.spmd import sharding as jshd
    from repro.spmd import zero as jzero
    from repro_torch.config import ParallelConfig, get_config
    from repro_torch.models import api
    from repro_torch.spmd import sharding as shd
    from repro_torch.spmd import zero
    n = 0
    for arch in ARCHS:
        cfg = get_config(arch)
        specs = dict(_spec_items(api.param_specs(cfg)))
        shapes = dict(_spec_items(api.param_shapes(cfg)))
        for fsdp in (False, True):
            rules = shd.make_rules(cfg, ParallelConfig(fsdp=fsdp))
            jrules = jshd.make_rules(cfg, JPar(fsdp=fsdp))
            for dm in MESHES:
                jmesh = AbstractMesh(dm, ("data", "model"))
                mesh = {"data": dm[0], "model": dm[1]}
                resolved = dict(_spec_items(shd.tree_pspecs(
                    api.param_shapes(cfg), api.param_specs(cfg), rules,
                    mesh)))
                for path, logical in specs.items():
                    shp = shapes[path]
                    mine = resolved[path]
                    ref = jshd.resolve_spec(shp, logical, jrules, jmesh)
                    assert mine == tuple(ref), (arch, path, dm)
                    assert zero.zero1_leaf_spec(shp, mine, mesh) == tuple(
                        jzero.zero1_leaf_spec(shp, ref, jmesh)), (arch, path)
                    n += 1
    assert n > 1000
    del jax


def test_batch_spec_agrees_with_jax():
    from jax.sharding import AbstractMesh
    from repro.spmd import sharding as jshd
    from repro_torch.spmd import sharding as shd
    for dm in MESHES:
        for b in (1, 2, 3, 4, 8):
            ref = jshd.batch_spec(b, AbstractMesh(dm, ("data", "model")))
            assert shd.batch_spec(b, {"data": dm[0], "model": dm[1]}) \
                == tuple(ref)


def test_train_mesh_is_process_wide():
    """The training mesh is seen from every thread (a CUDA backward, and
    remat's recompute in it, run on the autograd engine's own thread)."""
    import threading
    from repro_torch.spmd import collectives
    mesh, seen = object(), []
    with collectives.use_train(mesh):
        t = threading.Thread(target=lambda: seen.append(collectives.train()))
        t.start()
        t.join()
    assert seen == [mesh] and collectives.train() is None


def test_shard_outside_a_training_mesh_refused():
    """A leaf cut for "model" (a vocab shard, an ff slice, a rank's
    heads) met with no training mesh current: a ValueError naming it, not
    a silent partial sum."""
    from repro_torch.models.embedding import embed
    from repro_torch.models.layers import apply_mlp
    from repro_torch.models.transformer import _attn_part
    cfg = _cfg("glm4_9b")
    d, V, ff = cfg.d_model, cfg.padded_vocab_size, cfg.d_ff
    x = torch.zeros(1, 2, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="vocab rows of"):
        embed(torch.zeros(V // 2, d), torch.zeros(1, 2, dtype=torch.long),
              cfg)
    mlp = {"w_gate": torch.zeros(d, ff // 2), "w_in": torch.zeros(d, ff // 2),
           "w_out": torch.zeros(ff // 2, d)}
    with pytest.raises(ValueError, match="ff slice of"):
        apply_mlp(mlp, x, cfg)
    H, hd = cfg.num_heads // 2, cfg.head_dim
    lp = {"norm": {"scale": torch.ones(d)},
          "attn": {"wo": torch.zeros(H, hd, d)}}
    with pytest.raises(ValueError, match="heads of"):
        _attn_part(lp, x, cfg, lambda h: torch.zeros(1, 2, H, hd,
                                                     dtype=h.dtype))


# -- data parallel ------------------------------------------------------------


def test_data2_zero1_on_equals_off_bitwise(data2):
    """ZeRO-1 on and off: the same losses, grad norms and global state
    after 3 steps, bit for bit, on both ranks."""
    for res in data2:
        on, off = res["glm4_9b"], res["glm4_9b_zero_off"]
        assert on["loss"] == off["loss"] and on["gnorm"] == off["gnorm"]
        assert _same_bits(on["global"], off["global"])
        assert _same_bits(on["local"], off["local"])


@pytest.mark.parametrize("name", ["glm4_9b", "glm4_9b_fp32"])
def test_data2_matches_one_device(data2, name):
    """data=2 against one device at the same global batches; the working
    params are the same bits on both ranks after every step."""
    close_run(data2[0][name], one(name), name)
    assert data2[0][name]["loss"] == data2[1][name]["loss"]
    assert _same_bits(data2[0][name]["local"], data2[1][name]["local"])
    assert _same_bits(data2[0][name]["global"], data2[1][name]["global"])


def test_data2_gradient_average_fp32_vs_bf16(data2):
    """The trainer averages the bf16 gradients over "data" in fp32. Both
    averages against one device's bf16 gradient of the whole batch (its
    rounding is the floor): the fp32 one no farther than a bf16 sum's."""
    from repro_torch.config import ParallelConfig, ShapeConfig
    from repro_torch.models import api
    from repro_torch.optim.optimizers import working_params
    from repro_torch.optim.optimizers import init_train_state
    from repro_torch.config import OptimizerConfig
    cfg = _cfg("glm4_9b")
    params = working_params(init_train_state(
        OptimizerConfig(), api.init_model(cfg, 0, "cpu", torch.float32)))
    batch = api.make_batch(cfg, ShapeConfig("t", S, B, "train"), 0, "cpu")
    loss, _ = api.loss_fn(params, batch, cfg, ParallelConfig(remat="none"))
    ref = torch.autograd.grad(loss, _leaves(params))
    gaps = {}
    for dt, got in data2[0]["grad_average"].items():
        gaps[dt] = max(float((a.float() - b.float()).abs().max()
                             / b.float().abs().max())
                       for a, b in zip(got, ref))
    print("gradient average vs one device, max relative to each leaf's "
          "largest element:", gaps)
    assert gaps["float32"] <= gaps["bfloat16"] < 2 ** -6


# -- tensor parallel ----------------------------------------------------------


TP_CASES = [n for a in DENSE for n in (a, a + "_fp32")]


@pytest.mark.parametrize("name", TP_CASES + ["qwen3_32b", "qwen3_32b_fp32",
                                             "seq", "heads", "seq_fp32",
                                             "heads_fp32"])
def test_model2_matches_one_device(model2, name):
    """model=2 against one device: losses and grad norms, the fp32
    masters; the leaves no rank shards (norms, qwen3's qk-norm scales) the
    same bits on both ranks. "seq": the sequence-split fallback; "heads":
    query heads cut contiguously, kv heads whole."""
    close_run(model2[0][name], one(name), name)
    assert model2[0][name]["loss"] == model2[1][name]["loss"]
    assert _same_bits(model2[0][name]["global"], model2[1][name]["global"])
    replicated_same(model2, name, (1, 2))


@pytest.mark.parametrize("name", TP_CASES)
def test_data2_model2_matches_one_device(dm4, name):
    close_run(dm4[0][name], one(name), name)
    for r in dm4[1:]:
        assert r[name]["loss"] == dm4[0][name]["loss"]
        assert _same_bits(r[name]["global"], dm4[0][name]["global"])
    replicated_same(dm4, name, (2, 2))


def test_shard_then_gather_round_trips_bitwise(dm4):
    assert all(r["roundtrip"] for r in dm4)


def test_tp_refused_for_other_families(model2):
    for arch in OTHERS:
        msg = model2[0]["refusals"][arch]
        assert msg is not None and "ROADMAP.md queue 1 item 12" in msg, arch
        assert "tensor-parallel training" in msg


# -- checkpoints --------------------------------------------------------------


def test_restore_for_mesh_data2_to_model2_and_one_device(data2, model2, tmp):
    """The data=2 run's checkpoint (ZeRO-1 slices gathered) holds its
    global tree; restored at model=2 every shard is its slice bit for
    bit, and one more step there matches the same step on one device
    from the same checkpoint."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.checkpoint.elastic import restore_to
    from repro_torch.config import (OptimizerConfig, ParallelConfig,
                                    ShapeConfig)
    from repro_torch.models import api
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.spmd import steps as tsteps
    mgr = CheckpointManager(tmp / "data2" / "ckpt", keep=1)
    spec = data2[0]["glm4_9b"]["global"]
    step_no, whole = restore_to(mgr, spec, "cpu")
    assert step_no == STEPS and _same_bits(whole, spec)
    for r in model2:
        assert r["restore"]["step"] == STEPS and r["restore"]["exact"]
    cfg = _cfg("glm4_9b")
    ocfg = OptimizerConfig(**ADAMW)
    step = tsteps.make_train_step(cfg, ParallelConfig(remat="full"), ocfg)
    params = tree_map(lambda p: p.requires_grad_(), whole["params"])
    batch = api.make_batch(cfg, ShapeConfig("t", S, B, "train"), STEPS,
                           "cpu")
    _, state, m = step(params, whole["opt"], STEPS, batch)
    got = model2[0]["restore"]
    assert abs(got["loss"] - float(m["loss"])) <= 1e-2
    assert got["loss"] == model2[1]["restore"]["loss"]


# -- the JAX package on 4 host devices ---------------------------------------


JAX_CODE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.config import ParallelConfig, ShapeConfig, get_config
from repro.models import api
from repro.spmd.compression import compressed_psum_mean, init_error_state

out = dict()
mesh = jax.make_mesh((4,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
g = jnp.asarray(np.random.default_rng(0).normal(0, 1, (4, 37)), jnp.float32)

def body(g, e):
    o, ne = compressed_psum_mean(g[0], e[0], "data")
    return o, ne[None]

with jax.set_mesh(mesh):
    o, ne = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("data", None), P("data", None)),
        out_specs=(P(None), P("data", None)), check_vma=False))(
            g, jnp.zeros((4, 37), jnp.float32))
out["out"], out["err"] = np.asarray(o), np.asarray(ne)

with open(sys.argv[1], "rb") as f:
    inputs = pickle.load(f)
masters = inputs["moe"]
cfg = get_config("qwen3_moe_30b_a3b", smoke=True)
batch = api.make_batch(cfg, ShapeConfig("t", {S}, {B}, "train"), 0)
params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), masters)
for dm in ((1, 1), (2, 1)):
    mesh = jax.make_mesh(dm, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:dm[0]])
    with jax.set_mesh(mesh):
        loss, _ = jax.jit(lambda p, b: api.loss_fn(
            p, b, cfg, ParallelConfig(remat="full")))(params, batch)
    out[f"moe_{{dm[0]}}"] = float(loss)

import dataclasses
from repro.config import OptimizerConfig
from repro.optim import optimizers as jopt
from repro.spmd import steps as jsteps
ocfg = OptimizerConfig(**{SGD!r})
pcfg = ParallelConfig(remat="full")
for key, c in inputs["dense"].items():
    cfg = dataclasses.replace(get_config(c["arch"], smoke=True),
                              dtype=c["dtype"])
    dm = c["mesh"]
    mesh = jax.make_mesh(dm, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:dm[0] * dm[1]])
    _, specs = api.abstract_params(cfg)
    with jax.set_mesh(mesh):
        state = jopt.init_train_state(ocfg, jax.tree.map(
            jnp.asarray, inputs["masters"][c["arch"]]))
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                              state["master"])
        psh = jsteps.resolve_param_shardings(params, specs, cfg, pcfg, mesh)
        osh = jsteps.opt_state_shardings(
            jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                         state), state["master"], specs, cfg, pcfg, mesh)
        params = jax.tree.map(jax.device_put, params, psh)
        state = jax.tree.map(jax.device_put, state, osh)
        step = jax.jit(jsteps.make_train_step(cfg, pcfg, ocfg))
        res = {{"loss": [], "gnorm": []}}
        for i, b in enumerate(c["batches"]):
            params, state, m = step(params, state, jnp.asarray(i, jnp.int32),
                                    {{k: jnp.asarray(v) for k, v in b.items()}})
            res["loss"].append(float(m["loss"]))
            res["gnorm"].append(float(m["grad_norm"]))
    out[key] = res
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


# the port's fp32 mesh runs held to the JAX package's at the same mesh
JAX_MESH_CASES = ([("glm4_9b_fp32", (2, 1)), ("qwen3_32b_fp32", (1, 2))]
                  + [(a + "_fp32", shape) for shape in ((1, 2), (2, 2))
                     for a in DENSE])


def _jax_key(name, shape):
    return f"{name}@data={shape[0]},model={shape[1]}"


@pytest.fixture(scope="module")
def jax_started(tmp):
    """The JAX package's subprocess on 4 host devices (``JAX_CODE``, as
    ``helpers.run_with_devices`` runs it), started and not waited for, so
    that it runs beside the gloo worlds: (process, its result's path)."""
    import os
    import subprocess
    import sys

    from helpers import SRC
    from torch_train_cases import jax_layout
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.models import api

    def masters(cfg):
        return jax_layout(api.init_model(cfg, 0, "cpu", torch.float32), cfg)
    inputs = {"moe": masters(get_config("qwen3_moe_30b_a3b", smoke=True)),
              "masters": {}, "dense": {}}
    for name, shape in JAX_MESH_CASES:
        cfg, arch = _cfg(name), name.partition("_fp32")[0]
        if arch not in inputs["masters"]:
            inputs["masters"][arch] = masters(cfg)
        inputs["dense"][_jax_key(name, shape)] = {
            "arch": arch, "dtype": cfg.dtype, "mesh": shape,
            "batches": [{k: v.numpy() for k, v in api.make_batch(
                cfg, ShapeConfig("t", S, B, "train"), i, "cpu").items()}
                for i in range(STEPS)]}
    src, dst = tmp / "jax_inputs.pkl", tmp / "jax_ref.pkl"
    with open(src, "wb") as f:
        pickle.dump(inputs, f)
    code = (JAX_CODE.format(S=S, B=B, SGD=SGD)
            .replace("sys.argv[1]", repr(str(src)))
            .replace("sys.argv[2]", repr(str(dst))))
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        + env.get("XLA_FLAGS", "")).strip()
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with open(tmp / "jax.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                stdout=log, stderr=subprocess.STDOUT)
    yield proc, dst
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_ref(tmp, jax_started):
    proc, dst = jax_started
    rc = proc.wait(timeout=600)
    assert rc == 0, f"JAX subprocess rc={rc}:\n" + \
        (tmp / "jax.log").read_text()[-4000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


def test_compressed_psum_mean_vs_jax(dm4, jax_ref):
    """Over 4 gloo ranks against the JAX package under shard_map on 4 host
    devices, same inputs: outputs and errors within 1e-6 (and the bits
    compared); the one-shot relative error and the 20-step EF drift of
    ``tests/test_compression.py``."""
    outs = [r["compression"] for r in dm4]
    for rank, c in enumerate(outs):
        assert np.abs(c["out"].numpy() - jax_ref["out"]).max() <= 1e-6
        assert np.abs(c["err"].numpy() - jax_ref["err"][rank]).max() <= 1e-6
        true = c["true"].numpy()
        rel = np.abs(c["out"].numpy() - true).max() / (np.abs(true).max()
                                                       + 1e-9)
        assert rel < 0.05
        assert np.abs(c["applied"].numpy() - true).max() < 0.02
    print("compression bits equal to the JAX package's:",
          all(np.array_equal(c["out"].numpy(), jax_ref["out"])
              and np.array_equal(c["err"].numpy(), jax_ref["err"][r])
              for r, c in enumerate(outs)))


def test_moe_data2_loss_vs_jax(data2, jax_ref):
    """qwen3_moe's smoke loss at data=2 (each data rank routes its own
    rows, the capacity from its own tokens) against the JAX package's at
    data=2, on the same masters and batch: within 1e-2."""
    got = data2[0]["moe"]["loss"][0]
    assert got == data2[1]["moe"]["loss"][0]
    assert abs(got - jax_ref["moe_2"]) <= 1e-2, (got, jax_ref)


@pytest.mark.parametrize("name,shape", JAX_MESH_CASES,
                         ids=[_jax_key(*c) for c in JAX_MESH_CASES])
def test_mesh_matches_jax(request, jax_ref, name, shape):
    """The port's fp32 mesh run (the vocab-parallel embedding and loss, the
    kv-group head cut, the row-parallel sums, the gradient average)
    against the JAX package's ``make_train_step`` on the same mesh shape
    (its placement: ``resolve_param_shardings``, ZeRO-1 state), the same
    masters and batches, 3 SGD steps: the fp32 rungs of ``close_run``,
    the first step's loss within 1e-5 and grad norm within 1e-4
    relative, every step's loss within 1e-3 and grad norm within 1e-2
    relative."""
    world = {(2, 1): "data2", (1, 2): "model2", (2, 2): "dm4"}[shape]
    got = request.getfixturevalue(world)[0][name]
    ref = jax_ref[_jax_key(name, shape)]
    print(name, shape, "loss", got["loss"], ref["loss"], "grad norm",
          got["gnorm"], ref["gnorm"])
    assert abs(got["loss"][0] - ref["loss"][0]) <= 1e-5
    assert abs(got["gnorm"][0] - ref["gnorm"][0]) <= 1e-4 * ref["gnorm"][0]
    for a, b in zip(got["loss"], ref["loss"], strict=True):
        assert abs(a - b) <= 1e-3, (got["loss"], ref["loss"])
    for a, b in zip(got["gnorm"], ref["gnorm"], strict=True):
        assert abs(a - b) <= 1e-2 * b, (got["gnorm"], ref["gnorm"])


def test_cli_mesh_trains_and_resumes_at_another_shape(tmp_path, capfd):
    """``launch.train --mesh data=2,model=2`` spawns 4 ranks over gloo and
    writes a checkpoint; ``--mesh model=2 --resume`` continues from it
    (``run_mesh`` with a checkpoint every 2 steps, then every step, in
    place of the CLI's 50, to keep the runs short)."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.launch import train as cli

    def run(*extra, ckpt_every):
        cli.run_mesh(cli.parse_args([
            "--arch", "glm4_9b", "--smoke", "--device", "cpu", "--batch",
            "4", "--seq", "8", "--ckpt", str(tmp_path), *extra]),
            ckpt_every=ckpt_every, log_every=1)
        return capfd.readouterr().out
    out = run("--mesh", "data=2,model=2", "--steps", "2", ckpt_every=2)
    assert "4 ranks over gloo" in out and "[train] done." in out
    assert CheckpointManager(tmp_path).steps() == [2]
    out = run("--mesh", "model=2", "--steps", "3", "--resume", ckpt_every=1)
    assert "[train] resumed from step 2" in out and "[train] step 3 " in out
    assert CheckpointManager(tmp_path).latest_step() == 3
