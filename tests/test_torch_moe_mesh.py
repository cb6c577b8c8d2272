"""The port's mixture-of-experts block on a serving mesh (``models.moe``
under ``spmd.collectives.ServeMesh``) against the JAX package's
``moe_block`` on the same mesh shape, at both MoE smoke configs
(qwen3-moe: 8 experts top-2; grok-1: 4 experts top-2, GeGLU), fp32.

The reference runs in a subprocess with 4 virtual CPU devices
(``helpers.run_with_devices``): layer 0's moe leaves of its seed-0 init,
seeded numpy inputs (rows sharing a component, so that experts
overflow), each case on a ("data", "model") mesh, jitted, and "ep_a2a"
also on one device. The port runs the same leaves and inputs over gloo:
a world of two CPU processes (mesh 1 x 2) and one of four (2 x 2),
spawned, the rendezvous a file in the test's tmp_path. Cases, at
capacity factors 1.25 (the default) and 100 (no drops):

- "ep_psum": model=2, B 4, S 1 (a decode step): each rank its 4 / 2
  experts of every row, the capacity of all T, the outputs summed;
- "ep_a2a": model=2, B 4, S 8: each rank its S / 2 rows with their own
  capacity, all-to-all to the experts' owners and back;
- "f2d": data=2 x model=2, grok-1's layout: expert d_ff over both axes;
- "dp_a2a": data=2 x model=2 without f2d: the batch rows split over
  "data" (each data shard's own capacity), "ep_a2a" over "model".

Every case's output within 1e-5 of the reference's largest value, its
aux within 1e-5 relative; every rank the same bits; the same with the
leaves cut to the rank's shard first (as ``shard_params=True`` stores
them), bit for bit the whole leaves' result. At capacity factor 1.25
"ep_a2a" drops other assignments than one device does: the port's output
differs from its one-device output exactly where the reference's
differs from its own, and for qwen3-moe it does."""

import pickle

import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_cpu  # noqa: F401  (one torch thread)
from helpers import run_with_devices

ARCHS = ("qwen3_moe_30b_a3b", "grok1_314b")
CFS = (1.25, 100.0)
# name -> (data, model, B, S, f2d)
CASES = {"ep_psum": (1, 2, 4, 1, False), "ep_a2a": (1, 2, 4, 8, False),
         "f2d": (2, 2, 4, 8, True), "dp_a2a": (2, 2, 4, 8, False)}
MODE = {"ep_psum": "ep_psum", "ep_a2a": "ep_a2a", "f2d": "f2d",
        "dp_a2a": "ep_a2a"}
FP32_TOL = 1e-5
JOIN_TIMEOUT_S = 240

REFERENCE = """
import dataclasses, functools, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.config import get_config
from repro.models import api, moe
ARCHS, CFS, CASES = {archs!r}, {cfs!r}, {cases!r}
auto = (jax.sharding.AxisType.Auto,) * 2
def mesh(data, model):
    return jax.make_mesh((data, model), ("data", "model"), auto,
                         devices=jax.devices()[:data * model])
out = {{}}
for arch in ARCHS:
    base = get_config(arch, smoke=True)
    with jax.set_mesh(mesh(1, 1)):
        pf, _ = api.init_model(base, jax.random.key(0))
    p = {{k: np.array(v[0], np.float32)
         for k, v in pf["blocks"]["sub0"]["moe"].items()}}
    out[arch] = {{"params": p}}
    for cf in CFS:
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf))
        for name, (data, model, B, S, f2d) in CASES.items():
            # rows sharing a component route alike: experts overflow
            rng = np.random.default_rng(len(name) * 7 + S)
            x = (rng.normal(0, 1, (B, S, base.d_model))
                 + 2 * rng.normal(0, 1, base.d_model)).astype(np.float32)
            pj = {{k: jnp.asarray(v) for k, v in p.items()}}
            res = {{"x": x}}
            for key, shape in (("y", (data, model)), ("one", (1, 1))):
                if key == "one" and name != "ep_a2a":
                    continue
                fn = jax.jit(functools.partial(moe.moe_block, cfg=cfg,
                                               f2d=f2d and key == "y"))
                with jax.set_mesh(mesh(*shape)):
                    y, aux = fn(pj, jnp.asarray(x))
                res[key] = (np.asarray(y), float(aux))
            out[arch][(cf, name)] = res
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
"""


def _cfg(arch, cf):
    import dataclasses
    from repro_torch.config import get_config
    c = get_config(arch, smoke=True)
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cf))


def _rank(rank, world, data, model, init_method, ref_path, out_dir):
    """One rank of a ``data`` x ``model`` world: every case of that mesh
    shape with whole leaves and with the rank's shard of them, and each
    case's one-device output; pickled into ``out_dir``."""
    import torch
    from repro_torch.launch.mesh import init_rank, make_host_mesh
    from repro_torch.models import moe
    from repro_torch.spmd import collectives
    torch.set_num_threads(1)
    init_rank(rank, world, init_method, "cpu", timeout_s=120)
    sm = collectives.ServeMesh(make_host_mesh(data, model, "cpu"))
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    res = {}
    for arch in ARCHS:
        p = {k: torch.from_numpy(v) for k, v in ref[arch]["params"].items()}
        for cf in CFS:
            cfg = _cfg(arch, cf)
            for name, (d, m, B, S, f2d) in CASES.items():
                if (d, m) != (data, model):
                    continue
                x = torch.from_numpy(ref[arch][(cf, name)]["x"])
                n = sm.both.size if f2d else m
                cut = moe.expert_cut(cfg, m, f2d)
                i = sm.both.rank if f2d else sm.model.rank
                shard = dict(p)
                if cut == "experts":
                    E = cfg.moe.num_experts // n
                    for k in ("w_gate", "w_in", "w_out"):
                        shard[k] = p[k][i * E:(i + 1) * E].clone()
                else:
                    f = cfg.moe.d_ff_expert // n
                    for k in ("w_gate", "w_in"):
                        shard[k] = p[k][..., i * f:(i + 1) * f].clone()
                    shard["w_out"] = p["w_out"][:, i * f:(i + 1) * f].clone()
                got = {}
                sm.f2d = f2d            # the engine's pcfg.expert_ff_2d
                for key, leaves in (("whole", p), ("shard", shard)):
                    with collectives.use(sm):
                        y, aux = moe.moe_block(leaves, x, cfg, with_aux=True)
                    got[key] = (y.numpy(), float(aux))
                y1, a1 = moe.moe_block(p, x, cfg, with_aux=True)
                got["one"] = (y1.numpy(), float(a1))
                res[(arch, cf, name)] = got
    res["modes"] = dict(sm.moe_modes)
    with open(f"{out_dir}/{data}x{model}_rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _world(data, model, ref_path, d):
    """Start the ``data`` x ``model`` world's spawned ranks; their
    processes."""
    world = data * model
    ctx = mp.get_context("spawn")
    init = f"file://{d}/rdzv_{data}x{model}"
    procs = [ctx.Process(target=_rank, args=(r, world, data, model, init,
                                             ref_path, str(d)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, {(data, model): [rank results]})."""
    d = tmp_path_factory.mktemp("moe_mesh")
    ref_path = str(d / "reference.pkl")
    run_with_devices(REFERENCE.format(archs=ARCHS, cfs=CFS, cases=CASES,
                                      path=ref_path), n_devices=4)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    shapes = ((1, 2), (2, 2))
    procs = {s: _world(*s, ref_path, d) for s in shapes}
    for ps in procs.values():
        for p in ps:
            p.join(JOIN_TIMEOUT_S)
    alive = [p for ps in procs.values() for p in ps if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"ranks still running after {JOIN_TIMEOUT_S} s"
    codes = {s: [p.exitcode for p in ps] for s, ps in procs.items()}
    assert all(c == [0] * len(c) for c in codes.values()), codes
    port = {}
    for data, model in shapes:
        port[(data, model)] = []
        for r in range(data * model):
            with open(d / f"{data}x{model}_rank{r}.pkl", "rb") as f:
                port[(data, model)].append(pickle.load(f))
    return ref, port


def _close(y, ref):
    err = float(np.abs(y - ref).max())
    assert err <= FP32_TOL * np.abs(ref).max(), err
    return err


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_mode_matches_reference(runs, arch, name, cf):
    """Every rank's output and aux against the reference's on the same
    mesh; whole leaves and the rank's shard give the same bits."""
    ref, port = runs
    data, model = CASES[name][:2]
    yr, ar = ref[arch][(cf, name)]["y"]
    ranks = port[(data, model)]
    first = ranks[0][(arch, cf, name)]
    for res in ranks:
        got = res[(arch, cf, name)]
        _close(got["whole"][0], yr)
        assert abs(got["whole"][1] - ar) <= FP32_TOL * abs(ar)
        np.testing.assert_array_equal(got["whole"][0], first["whole"][0])
        np.testing.assert_array_equal(got["shard"][0], got["whole"][0])
        assert got["shard"][1] == got["whole"][1]
        assert res["modes"][MODE[name]] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_a2a_capacity_is_per_shard(runs, arch):
    """At capacity factor 1.25 the port's "ep_a2a" output parts from its
    one-device output exactly where the reference's does (each shard's
    capacity comes from its own rows); at 100, where nothing drops, it
    matches one device. qwen3-moe's parts."""
    ref, port = runs
    for cf in CFS:
        res = ref[arch][(cf, "ep_a2a")]
        got = port[(1, 2)][0][(arch, cf, "ep_a2a")]
        ref_parts = np.abs(res["y"][0] - res["one"][0]).max() \
            > 100 * FP32_TOL * np.abs(res["one"][0]).max()
        port_parts = np.abs(got["whole"][0] - got["one"][0]).max() \
            > 100 * FP32_TOL * np.abs(got["one"][0]).max()
        assert port_parts == ref_parts, (arch, cf)
        _close(got["one"][0], res["one"][0])
        if cf == 100.0:
            assert not ref_parts
        elif arch == "qwen3_moe_30b_a3b":
            assert ref_parts
