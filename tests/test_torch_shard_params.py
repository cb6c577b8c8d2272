"""Weight-sharded tensor-parallel serving (``InferenceEngine(mesh=...,
shard_params=True)``) and the MoE block's mesh modes in the engine, held
against the port's own tp = 1 engine on the CPU (tp = 1 is held against
the JAX engine by the engine tests; the MoE block's modes against the
JAX block by ``test_torch_moe_mesh.py``).

Gloo worlds of spawned CPU processes (the rendezvous a file in the
test's tmp_path): two ranks on a mesh ("data", "model") = (1, 2), four on
(2, 2). Rank 0 drives, the others follow, each under
``debug_invariants`` (the ranks compare a digest of every step plan).
The test process runs the same requests on one engine, the same seed-0
weights. Runs (``test_torch_tp.py``'s prompts and tight pool: a prefix
hit with a copy-on-write, preemption):

- glm4 and qwen3_moe smoke, model=2, ``shard_params=True``;
- qwen3_moe smoke, model=2, weights whole: its decode steps run
  "ep_psum", its 12-row chunks "ep_a2a";
- grok1 smoke, data=2 x model=2, ``pcfg.expert_ff_2d`` and
  ``shard_params=True``: the expert d_ff over all four ranks.

A sharded run's sums come in another order (partial sums over
"model"), and under "ep_a2a" a shard's own capacity drops other
assignments, so a MoE run is held against tp = 1 replaying its routing
(``models.moe_replay``): every keep mask the mesh's capacity rule's, the
router log-probabilities of the rows both runs share within ROUTER_TOL,
each row that the replay's own router routes elsewhere within twice its
gap of a tie. Rank 0's greedy tokens equal tp = 1's (for a MoE model,
the replay's) up to a near-tie (tp = 1's scores put rank 0's token less
than 1e-2, or twice the rows' gap there, below its own), and the logits
rows up to it are within LOGITS_TOL; the scheduling stats equal tp =
1's; each rank holds its shard of every leaf (``weight_bytes`` the
layouts' sum, under 0.6 of tp = 1's). The SSM, hybrid, encoder-decoder
and VLM families and ``pcfg.fsdp`` are refused by name."""

import math
import pickle

import pytest
import torch.multiprocessing as mp

import torch_cpu  # noqa: F401  (one torch thread)
from test_torch_tp import SCHED_STATS, TIGHT, _requests

JOIN_TIMEOUT_S = 240
NEAR_TIE = 1e-2
# a sharded run's gaps to tp = 1 (bf16, two smoke layers): the logits rows
# before a parting, and the router log-probabilities of the rows both runs
# share (0.017-0.031 and 0.018-0.035 read; whole weights 0)
LOGITS_TOL = 0.1
ROUTER_TOL = 0.1
# name -> (arch, engine keywords, expert_ff_2d, (data, model))
RUNS = {
    "glm4": ("glm4_9b", dict(TIGHT, shard_params=True), False, (1, 2)),
    "qwen3_moe": ("qwen3_moe_30b_a3b", dict(TIGHT, shard_params=True),
                  False, (1, 2)),
    "qwen3_moe_whole": ("qwen3_moe_30b_a3b", dict(TIGHT), False, (1, 2)),
    "grok1_f2d": ("grok1_314b", dict(TIGHT, shard_params=True), True,
                  (2, 2)),
}
REFUSED = ("mamba2_370m", "zamba2_2p7b", "whisper_large_v3", "qwen2_vl_2b")


def _record(eng, replay=None):
    """Make ``eng`` record, for each token a request emits, its fp32
    logits row ("rows", (rid, index) -> [top-2 margin, top-1, top-2,
    the row]) and, for a MoE model, every MoE call's routing
    (``moe_replay.RouteRecord``, "route"). ``replay``: (the mesh's merged
    calls, its (data, model) shape, f2d): the MoE blocks replay them
    (``moe_replay.Replay``, "replay"). Returns the record."""
    import torch
    from repro_torch.models import moe_replay
    route = moe_replay.RouteRecord()
    rec = {"rows": {}, "route": route, "replay": None}
    if replay is not None:
        mesh, (data, model), f2d = replay
        assert f2d or data == 1, "a replay of MoE rows split over data"
        rec["replay"] = moe_replay.Replay(mesh, route, model, f2d)
    pending = []
    forward, run_step, step = eng._forward, eng._run_step, eng._step

    def forward_read(has_chunk, mode="greedy"):
        out = forward(has_chunk, mode)
        eng._read_logits = out["logits"].float()
        return out

    def run_step_read(plan):
        route.begin_step({
            eng.max_batch: {s: (r.rid, r.num_computed)
                            for s, r in plan.decodes},
            eng.chunk_width: {i: (r.rid, r.num_computed + i)
                              for _, r, n in plan.chunks for i in range(n)}})
        out = run_step(plan)
        lg = eng._read_logits
        top = torch.topk(lg, 2, dim=-1)
        vals, ids = top.values.tolist(), top.indices.tolist()
        rows = [(s, r) for s, r in plan.decodes] + [
            (eng.max_batch + i, r) for i, (_, r, _) in enumerate(plan.chunks)]
        for row, req in rows:
            pending.append((req, len(req.out), [
                vals[row][0] - vals[row][1], *ids[row], lg[row].clone()]))
        return out

    def step_read():
        ran = step()
        for req, n, row in pending:
            if len(req.out) > n:
                rec["rows"][(req.rid, n)] = row
        pending.clear()
        return ran

    eng._forward, eng._run_step, eng._step = (forward_read, run_step_read,
                                              step_read)
    return rec


def _serve(arch, kw, f2d, mesh=None, replay=None) -> dict:
    """One run on one engine (tp = 1; with ``replay``, replaying a mesh's
    MoE routing, see ``_record``) or on this rank of ``mesh``: tokens,
    logits rows and the routing record by request order, scheduling
    stats, the engine's weight bytes and MoE mode counts."""
    import contextlib
    from repro_torch.config import ParallelConfig, get_config
    from repro_torch.models import moe, moe_replay
    from repro_torch.serving import InferenceEngine
    cfg = get_config(arch, smoke=True)
    eng = InferenceEngine(cfg, device="cpu", mesh=mesh,
                          pcfg=ParallelConfig(expert_ff_2d=f2d),
                          debug_invariants=True, **kw)
    rec = _record(eng, replay)
    reqs, arrivals = _requests(cfg)
    if cfg.moe is not None and replay is None:
        moe.route_tap = rec["route"].tap
    try:
        with (moe_replay.replaying(rec["replay"]) if replay is not None
              else contextlib.nullcontext()):
            if eng.group is None or eng.group.rank == 0:
                outs = eng.run(reqs, arrival_steps=arrivals)
                eng.close()
                rids = [r.rid for r in reqs]
            else:
                outs = eng.follow()
                rids = sorted(outs)
    finally:
        moe.route_tap = None
    order = {rid: i for i, rid in enumerate(rids)}
    rec["route"].rename(order)
    s = eng.stats
    return {"tokens": [outs[rid].tolist() for rid in rids],
            "prompts": [len(r.prompt) for r in reqs],
            "rows": {(order[rid], n): v
                     for (rid, n), v in rec["rows"].items()},
            "route": rec["route"].state(),
            "missing": rec["replay"] and rec["replay"].missing,
            "sched": {k: s[k] for k in SCHED_STATS},
            "weight_bytes": s["weight_bytes"], "moe_modes": s["moe_modes"],
            "shard_params": s["shard_params"], "reduces": s["tp_reduces"]}


def _refusals(mesh) -> list:
    """The messages of the refused constructions on ``mesh``."""
    from repro_torch.config import ParallelConfig, get_config
    from repro_torch.serving import InferenceEngine
    out = []
    for arch in REFUSED:
        try:
            InferenceEngine(get_config(arch, smoke=True), device="cpu",
                            mesh=mesh, shard_params=True)
            out.append(None)
        except NotImplementedError as e:
            out.append(str(e))
    try:
        InferenceEngine(get_config("glm4_9b", smoke=True), device="cpu",
                        mesh=mesh, shard_params=True,
                        pcfg=ParallelConfig(fsdp=True))
        out.append(None)
    except NotImplementedError as e:
        out.append(str(e))
    return out


def _rank(rank, world, shape, init_method, out_dir):
    """One rank of a ``shape`` = (data, model) world: its RUNS, on (1, 2)
    the refusals too; pickled into ``out_dir``."""
    import torch
    from repro_torch.launch.mesh import init_rank, make_host_mesh
    torch.set_num_threads(1)
    init_rank(rank, world, init_method, "cpu", timeout_s=120)
    mesh = make_host_mesh(*shape, "cpu")
    res = {name: _serve(arch, kw, f2d, mesh)
           for name, (arch, kw, f2d, where) in RUNS.items() if where == shape}
    if shape == (1, 2):
        res["refused"] = _refusals(mesh)
    with open(f"{out_dir}/{shape[0]}x{shape[1]}_rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{(data, model): [each rank's results]}; fails unless every rank
    exits 0 within the join timeout."""
    d = tmp_path_factory.mktemp("shard_params")
    ctx = mp.get_context("spawn")
    shapes = ((1, 2), (2, 2))
    procs = {}
    for shape in shapes:
        world = shape[0] * shape[1]
        init = f"file://{d}/rdzv_{shape[0]}x{shape[1]}"
        procs[shape] = [ctx.Process(target=_rank,
                                    args=(r, world, shape, init, str(d)))
                        for r in range(world)]
        for p in procs[shape]:
            p.start()
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
    out = {}
    for shape in shapes:
        out[shape] = []
        for r in range(shape[0] * shape[1]):
            with open(d / f"{shape[0]}x{shape[1]}_rank{r}.pkl", "rb") as f:
                out[shape].append(pickle.load(f))
    return out


def _first(mine, base) -> list:
    """Each request's first token index where the two runs part (its
    length where they do not)."""
    return [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b))) for a, b in zip(mine["tokens"],
                                                      base["tokens"])]


def _explained(mine, base, first):
    """None where ``mine``'s tokens equal ``base``'s up to a first
    difference at a near-tie: ``base``'s scores put ``mine``'s token less
    than NEAR_TIE, or twice the two rows' largest |difference| there
    (each score moved by at most that), below its own; else what is
    unexplained."""
    for r, (a, b) in enumerate(zip(mine["tokens"], base["tokens"])):
        i = first[r]
        if i == len(a) == len(b):
            continue
        if i == min(len(a), len(b)):
            return f"request {r}: {len(a)} tokens against {len(b)}"
        row = base["rows"][(r, i)][3]
        margin = float(row[b[i]] - row[a[i]])
        gap = float((mine["rows"][(r, i)][3] - row).abs().max())
        if not margin < max(NEAR_TIE, 2 * gap):
            return (f"request {r} token {i}: {a[i]} against {b[i]}, "
                    f"{margin} below it by the base's scores")
    return None


def _logits_gap(mine, base, first) -> float:
    """The largest |difference| of the two runs' fp32 logits rows of the
    tokens each request emitted up to its first differing one."""
    return max(float((mine["rows"][(r, j)][3] - base["rows"][(r, j)][3])
                     .abs().max())
               for r, i in enumerate(first)
               for j in range(min(i + 1, len(mine["tokens"][r]))))


def _layout_bytes(cfg, f2d, shape) -> int:
    """Bytes of one rank's shard of every leaf by the serving layouts."""
    from repro_torch.config import ParallelConfig
    from repro_torch.models.api import param_shapes
    from repro_torch.spmd import sharding as shd
    sizes = {"data": shape[0], "model": shape[1]}
    lay = shd.serving_layouts(cfg, ParallelConfig(expert_ff_2d=f2d), sizes)
    coords = {"data": 0, "model": 0}
    total = []
    shd.map_specs(lambda s, lt: total.append(math.prod(s) // math.prod(
        lt.index(d, coords, sizes)[1] for d in range(len(s)))),
        param_shapes(cfg), lay)
    return sum(total) * (2 if cfg.dtype == "bfloat16" else 4)


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_run_against_tp1(worlds, name):
    """Every rank's tokens the same as rank 0's, its scheduling stats tp =
    1's; sharded weights are the layouts' shard of every leaf, under 0.6
    of tp = 1's bytes. Rank 0's tokens equal tp = 1's up to a near-tie of
    tp = 1's, its logits rows before that within LOGITS_TOL. For a MoE
    model tp = 1 replays the mesh's routing (``models.moe_replay``):
    every call replayed, every keep mask the mesh's under its capacity
    rule, the router log-probabilities of the rows both runs share within
    ROUTER_TOL, and a row the replay's own router routes elsewhere within
    twice its gap of a tie."""
    from repro_torch.config import get_config
    from repro_torch.models import moe_replay
    arch, kw, f2d, shape = RUNS[name]
    kw1 = {k: v for k, v in kw.items() if k != "shard_params"}
    one = _serve(arch, kw1, f2d)
    cfg = get_config(arch, smoke=True)
    ranks = [res[name] for res in worlds[shape]]
    for rank, mine in enumerate(ranks):
        assert mine["tokens"] == ranks[0]["tokens"], rank
        assert mine["sched"] == one["sched"], (rank, name)
        assert mine["reduces"] > 0
        if kw.get("shard_params"):
            assert mine["shard_params"]
            assert mine["weight_bytes"] == _layout_bytes(cfg, f2d, shape)
            assert mine["weight_bytes"] < 0.6 * one["weight_bytes"]
        else:
            assert mine["weight_bytes"] == one["weight_bytes"]
    base = one
    if cfg.moe is not None:
        mesh = moe_replay.merge([m["route"]["calls"] for m in ranks])
        base = _serve(arch, kw1, f2d, replay=(mesh, shape, f2d))
        assert base["missing"] == 0 and base["sched"] == one["sched"]
    first = _first(ranks[0], base)
    why = _explained(ranks[0], base, first)
    assert why is None, (name, why)
    gap = _logits_gap(ranks[0], base, first)
    assert gap <= LOGITS_TOL, (name, gap)
    if cfg.moe is not None:
        cmp = moe_replay.compare(
            mesh, base["route"],
            lambda q, p: p < base["prompts"][q] + first[q])
        assert cmp["rows"] > 0 and cmp["keep_diffs"] == 0, (name, cmp)
        assert cmp["logp_gap"] <= ROUTER_TOL, (name, cmp["logp_gap"])
        assert all(t["tie"] <= 2 * t["gap"] for t in cmp["rerouted"]), \
            (name, cmp["rerouted"])


def test_moe_modes_by_step(worlds):
    """qwen3_moe on model=2: decode steps run "ep_psum" and the 12-row
    chunks "ep_a2a", weights whole or sharded; grok1 with expert_ff_2d
    runs "f2d" only."""
    for name in ("qwen3_moe", "qwen3_moe_whole"):
        for res in worlds[(1, 2)]:
            modes = res[name]["moe_modes"]
            assert set(modes) == {"ep_psum", "ep_a2a"}, modes
            assert min(modes.values()) > 0
    for res in worlds[(2, 2)]:
        assert set(res["grok1_f2d"]["moe_modes"]) == {"f2d"}


def test_refusals_name_the_family(worlds):
    """shard_params=True for the SSM, hybrid, encoder-decoder and VLM
    families, and with pcfg.fsdp, raises NotImplementedError naming what
    and ROADMAP's item, on every rank."""
    from repro_torch.config import get_config
    for res in worlds[(1, 2)]:
        msgs = res["refused"]
        assert all(m is not None and "ROADMAP.md queue 1 item 12" in m
                   for m in msgs), msgs
        for arch, m in zip(REFUSED, msgs):
            assert get_config(arch, smoke=True).family in m, m
        assert "fsdp" in msgs[-1]


def test_single_rank_ignores_shard_params():
    """Without a "model" axis the weights stay whole, as in the
    reference: shard_params=True on one engine is tp = 1's engine."""
    one = _serve("glm4_9b", dict(TIGHT), False)
    also = _serve("glm4_9b", dict(TIGHT, shard_params=True), False)
    assert not also["shard_params"]
    assert also["tokens"] == one["tokens"]
    assert also["weight_bytes"] == one["weight_bytes"]
