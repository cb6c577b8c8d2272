"""The port's engine on the mixture-of-experts decoders (qwen3-moe and
grok-1 at smoke size) on the CPU.

Against the JAX engine, at the default capacity factor (1.25, where a
chunk's tokens can be dropped): the same bf16 parameters and requests
give the same plans and the same greedy tokens through prefix hits with a
copy-on-write, preemption-recompute and chunked prefill. A stream may
part from the reference's only at a near-tie: at the first differing
token either both tokens are the port's top two with a margin below the
bf16 tolerance, or the two engines routed one of the request's rows
otherwise before that token was emitted (``RoutingLog``: in some layer,
at a position up to the token's input, the row's top-k experts or the
ones it kept within the capacity differ between the two runs; bf16
rounding, which the two frameworks do at other places, decides a close
router call, and the token's logits then move by far more than a
rounding). The port's routing and logits are recorded as its engine
runs, the JAX engine's routing by a callback in its jitted step.

Inside the port, at capacity factor 16 (no drops; the reference holds its
own equalities there too, ``tests/test_decode_consistency.py``): prefix
hit == cold, preempted == uninterrupted, packed == unpacked, and the
engine == the static path (``api.generate_static``) up to a near-tie,
with the static path's routing as the witness; the static decode == a
fresh prefill."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.config import get_config
from repro_torch.models import api, moe
from repro_torch.models.api import params_from_jax
from repro_torch.serving import InferenceEngine, Request
from repro_torch.serving.runners import TransformerRunner, make_runner
import torch_cpu  # noqa: F401  (one torch thread)

ARCHS = ["qwen3_moe_30b_a3b", "grok1_314b"]
BF16_TOL = 1e-2
# max_batch 2, 16-token blocks, 12-token chunks; 7 allocatable blocks
# force preemption once two requests pass 3 blocks each
TIGHT = dict(max_batch=2, block_size=16, max_len=96, num_blocks=8,
             max_num_batched_tokens=2 + 12)
ROOMY = dict(max_batch=2, block_size=16, max_len=96)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _cf(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _setup(mesh, arch, cf=None):
    """(JAX cfg, bf16 JAX tree, port cfg, port params) at capacity cf."""
    jcfg = jax_get_config(arch, smoke=True)
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jcfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), pf)
    tcfg = get_config(arch, smoke=True)
    if cf is not None:
        jcfg, tcfg = _cf(jcfg, cf), _cf(tcfg, cf)
    return jcfg, tree, tcfg, params_from_jax(tree, tcfg, "cpu")


def _prompts(vocab, seed=11):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 32).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, 8)
                            .astype(np.int32)]),
            prefix.copy(),                 # two full cached blocks: COW
            np.concatenate([prefix, rng.integers(0, vocab, 13)
                            .astype(np.int32)]),
            rng.integers(0, vocab, 20).astype(np.int32)]


class RoutingLog:
    """Every routed row of a run: ``events[(request, position, layer,
    occurrence)] = (tokens the request had emitted, its top-k experts, the
    ones kept within the capacity)``. ``step(rows)`` starts a step: rows
    {T: [(row, request, position, emitted), ...]} for each call width T
    the step routes (the decode batch's, the chunk's); ``call(idx)`` takes
    a call's (T, k) expert ids, the layers of one width in order."""

    def __init__(self, cfg):
        self.cfg, self.rows, self.layer, self.events = cfg, {}, {}, {}

    def step(self, rows):
        self.rows, self.layer = rows, {}

    def call(self, idx):
        idx = torch.from_numpy(np.array(idx)).long()
        T = idx.shape[0]
        layer = self.layer.get(T, 0)
        self.layer[T] = layer + 1
        kept = (moe._positions_in_expert(idx, self.cfg.moe.num_experts)
                < moe.capacity(self.cfg, T))
        for row, req, pos, emitted in self.rows[T]:
            ids = idx[row].tolist()
            occ = 0
            while (req, pos, layer, occ) in self.events:
                occ += 1
            self.events[(req, pos, layer, occ)] = (emitted, frozenset(ids), (
                frozenset(e for e, k in zip(ids, kept[row].tolist()) if k)))

    def routed_otherwise(self, other, req, last_pos, i) -> bool:
        """Whether ``other`` routed a row of request ``req`` at a position
        up to ``last_pos``, computed before its token i was emitted,
        otherwise than this run did."""
        return any(e[0] <= i and key in other.events
                   and other.events[key][1:] != e[1:]
                   for key, e in self.events.items()
                   if key[0] == req and key[1] <= last_pos)


def plan_rows(plan, reqs, B, W):
    """A pack-1 plan's routed rows by call width: decode slot s at the
    request's next position, chunk row i at its first uncomputed one + i
    (``reqs``: the run's requests, by identity)."""
    index = {id(r): n for n, r in enumerate(reqs)}
    rows = {B: [(s, index[id(r)], r.num_computed, len(r.out))
                for s, r in plan.decodes], W: []}
    for _, r, n in plan.chunks:
        rows[W] += [(i, index[id(r)], r.num_computed + i, len(r.out))
                    for i in range(n)]
    return rows


def spy_route(monkeypatch, log):
    """Feed every port ``moe._route`` call's expert ids to ``log``."""
    route = moe._route

    def spy(x, router, k):
        w, idx, probs = route(x, router, k)
        log.call(idx)
        return w, idx, probs
    monkeypatch.setattr(moe, "_route", spy)


def record(eng, log=None, reqs=None, monkeypatch=None):
    """Record, as ``eng`` runs, each emitted token's logit row (the port
    engine's own, V columns; {rid: [row, ...]}) and, with a ``log``, the
    routing of ``reqs`` into it. Needs prefill_pack 1 and chunk_width !=
    max_batch (a MoE call's row count says whether it is the chunk's or
    the decode batch's)."""
    out, state = {}, {}
    body, schedule = eng.runner_body, eng.sched.schedule
    B, V, W = eng.max_batch, eng.cfg.vocab_size, eng.chunk_width
    assert eng.prefill_pack == 1 and W != B
    if log is not None:
        spy_route(monkeypatch, log)

    def wrapped_schedule():
        state["plan"] = schedule()
        if log is not None:
            log.step(plan_rows(state["plan"], reqs, B, W))
        return state["plan"]

    def wrapped_body(**kw):
        res = body(**kw)
        state["logits"] = res["logits"].float().numpy()
        return res

    def on_token(req, tok, lp):
        plan = state["plan"]
        row = next((s for s, r in plan.decodes if r is req), None)
        if row is None:
            row = B + next(i for i, (_, r, _) in enumerate(plan.chunks)
                           if r is req)
        out.setdefault(req.rid, []).append(state["logits"][row, :V].copy())

    eng.runner_body, eng.sched.schedule, eng.on_token = (
        wrapped_body, wrapped_schedule, on_token)
    return out


def record_jax(jeng, reqs, log, monkeypatch):
    """The JAX engine's routing into ``log``: a host callback on the ids
    of every ``_route`` call in its jitted step (the caches are cleared so
    the step is traced anew with it)."""
    route = jmoe._route

    def spy(x, router, k):
        w, idx, probs = route(x, router, k)
        jax.debug.callback(log.call, idx)
        return w, idx, probs
    monkeypatch.setattr(jmoe, "_route", spy)
    jax.clear_caches()
    schedule = jeng.sched.schedule
    assert jeng.prefill_pack == 1 and jeng.chunk_width != jeng.max_batch

    def wrapped_schedule():
        jax.effects_barrier()
        plan = schedule()
        log.step(plan_rows(plan, reqs, jeng.max_batch, jeng.chunk_width))
        return plan

    jeng.sched.schedule = wrapped_schedule


def assert_same_or_near_tie(ours, ref, rows, prompt_len=0, witness=None,
                            tol=BF16_TOL):
    """Equal token streams, or a first difference at a near-tie of the
    port's logits (``rows``: the request's ``record``), or, for a MoE
    model, where ``witness(last_pos, i)`` says the two runs routed one of
    the request's rows up to token i's input position otherwise. Returns
    whether the routing escape was taken."""
    if ours == ref:
        return False
    i = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
    if witness is not None and witness(prompt_len + i - 1, i):
        return True
    row = rows[i]
    top2 = np.argsort(-row)[:2]
    margin = float(row[top2[0]] - row[top2[1]])
    assert set(top2.tolist()) == {ours[i], ref[i]}, (i, top2, margin)
    assert margin < tol, f"step {i}: margin {margin:.4g}"
    return False


def _run(tcfg, params, prompts, arrivals=None, max_new=20, log=None,
         monkeypatch=None, **kw):
    eng = InferenceEngine(tcfg, device="cpu", params=params,
                          debug_invariants=True, **kw)
    reqs = [Request(p.copy(), max_new=max_new) for p in prompts]
    rows = record(eng, log, reqs, monkeypatch) if log is not None else None
    outs = eng.run(reqs, arrival_steps=arrivals)
    return eng, [outs[r.rid].tolist() for r in reqs], \
        [rows[r.rid] for r in reqs] if rows is not None else None


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_reference(mesh, arch, monkeypatch):
    """Default capacity: the JAX engine's plans and greedy tokens; both
    engines routed the same rows of the same requests."""
    jcfg, tree, tcfg, params = _setup(mesh, arch)
    prompts = _prompts(jcfg.vocab_size)
    arrivals = [0, 5, 9, 9]
    jeng = JaxEngine(jcfg, mesh, params=jax.tree.map(jnp.asarray, tree),
                     debug_invariants=True, **TIGHT)
    jreqs = [JaxRequest(p.copy(), max_new=20) for p in prompts]
    jlog = RoutingLog(tcfg)
    record_jax(jeng, jreqs, jlog, monkeypatch)
    jouts = jeng.run(jreqs, arrival_steps=arrivals)
    jax.effects_barrier()
    log = RoutingLog(tcfg)
    eng, outs, rows = _run(tcfg, params, prompts, arrivals, log=log,
                           monkeypatch=monkeypatch, **TIGHT)
    s = eng.stats
    assert s["preemptions"] >= 1 and s["cow_copies"] >= 1
    assert s["cache_hit_tokens"] > 0 and s["prefill_chunks"] > len(prompts)
    for key in ("preemptions", "cache_hit_tokens", "cow_copies",
                "prefill_chunks", "steps", "tokens"):
        assert s[key] == jeng.stats[key], key
    assert log.events.keys() == jlog.events.keys()
    for n, (ours, jr, rr, p) in enumerate(zip(outs, jreqs, rows, prompts)):
        assert len(ours) == 20 and all(0 <= t < tcfg.vocab_size
                                       for t in ours)
        assert_same_or_near_tie(
            ours, jouts[jr.rid].tolist(), rr, len(p),
            lambda last, i, n=n: log.routed_otherwise(jlog, n, last, i))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_hit_equals_cold_at_cf16(mesh, arch):
    _, _, tcfg, params = _setup(mesh, arch, 16.0)
    prompts = _prompts(tcfg.vocab_size)
    eng, hit, _ = _run(tcfg, params, prompts, [0, 5, 9, 9], **ROOMY)
    assert eng.stats["cache_hit_tokens"] > 0 and eng.stats["cow_copies"] >= 1
    eng, cold, _ = _run(tcfg, params, prompts, [0, 5, 9, 9],
                        enable_prefix_caching=False, **ROOMY)
    assert eng.stats["cache_hit_tokens"] == 0
    assert hit == cold


@pytest.mark.parametrize("arch", ARCHS)
def test_preempted_equals_uninterrupted_at_cf16(mesh, arch):
    _, _, tcfg, params = _setup(mesh, arch, 16.0)
    prompts = _prompts(tcfg.vocab_size)[2:]
    _, free, _ = _run(tcfg, params, prompts, **ROOMY)
    eng, tight, _ = _run(tcfg, params, prompts, **TIGHT)
    assert eng.stats["preemptions"] >= 1
    assert tight == free


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_equals_unpacked_at_cf16(mesh, arch):
    """prefill_pack 3 over one 40-token chunk row: some step packs two
    prompts' chunks, and the tokens equal the unpacked run's."""
    _, _, tcfg, params = _setup(mesh, arch, 16.0)
    prompts = _prompts(tcfg.vocab_size, seed=5)
    kw = dict(max_batch=4, block_size=8, max_len=64,
              max_num_batched_tokens=4 + 40)
    _, one, _ = _run(tcfg, params, prompts, max_new=8, **kw)
    eng = InferenceEngine(tcfg, device="cpu", params=params,
                          debug_invariants=True, prefill_pack=3, **kw)
    schedule, widest = eng.sched.schedule, [0]

    def counted():
        plan = schedule()
        widest[0] = max(widest[0], len(plan.chunks))
        return plan

    eng.sched.schedule = counted
    reqs = [Request(p.copy(), max_new=8) for p in prompts]
    outs = eng.run(reqs)
    assert widest[0] >= 2
    assert [outs[r.rid].tolist() for r in reqs] == one


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_equals_static_path_at_cf16(mesh, arch, monkeypatch):
    """Four 24-token prompts, 12 new tokens each: the engine (16-token
    chunks) gives ``generate_static``'s tokens up to a near-tie, the
    static path's routing (one prefill call of B S rows, then a call of B
    rows per decode step) as the witness."""
    _, _, tcfg, params = _setup(mesh, arch, 16.0)
    B, S, max_new = 4, 24, 12
    rng = np.random.default_rng(13)
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    slog, state = RoutingLog(tcfg), {"j": 0}
    prefill, decode = api.prefill_fn, api.decode_fn

    def spy_prefill(*a, **kw):
        slog.step({B * S: [(b * S + s, b, s, 0) for b in range(B)
                           for s in range(S)]})
        return prefill(*a, **kw)

    def spy_decode(*a, **kw):
        state["j"] += 1
        j = state["j"]
        slog.step({B: [(b, b, S + j - 1, j) for b in range(B)]})
        return decode(*a, **kw)

    with monkeypatch.context() as m:
        spy_route(m, slog)
        m.setattr(api, "prefill_fn", spy_prefill)
        m.setattr(api, "decode_fn", spy_decode)
        want = api.generate_static(params, torch.from_numpy(toks), tcfg,
                                   max_new)
    assert state["j"] == max_new - 1
    log = RoutingLog(tcfg)
    eng, outs, rows = _run(tcfg, params, list(toks), max_new=max_new,
                           log=log, monkeypatch=monkeypatch, max_batch=B,
                           block_size=8, max_len=48,
                           max_num_batched_tokens=B + 16)
    assert eng.stats["prefill_chunks"] == 2 * len(toks)
    assert log.events.keys() == slog.events.keys()
    for n, (ours, w, rr) in enumerate(zip(outs, want, rows)):
        assert_same_or_near_tie(
            ours, w.tolist(), rr, S,
            lambda last, i, n=n: log.routed_otherwise(slog, n, last, i))


def test_decode_equals_fresh_prefill():
    """The port's ``test_decode_equals_fresh_prefill`` for qwen3-moe at
    capacity factor 16: prefill(S) into an S + 1 cache, then decode(token
    S), gives the token prefill(S + 1) gives."""
    cfg = _cf(get_config("qwen3_moe_30b_a3b", smoke=True), 16.0)
    params = api.init_model(cfg, 0, "cpu")
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    _, truth = api.prefill_fn(params, {"tokens": toks}, cfg)
    cache, _ = api.prefill_fn(params, {"tokens": toks[:, :S]}, cfg,
                              max_len=S + 1)
    tok, _ = api.decode_fn(params, cache, {
        "token": toks[:, S:], "pos": torch.full((B,), S, dtype=torch.int32)},
        cfg)
    assert torch.equal(tok, truth)


@pytest.mark.parametrize("arch", ARCHS)
def test_runner_and_cli(arch, capsys):
    """make_runner gives the paged transformer runner; the serve CLI
    serves the arch at smoke size."""
    cfg = get_config(arch, smoke=True)
    assert type(make_runner(cfg)) is TransformerRunner
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--requests", "2", "--max-new", "3", "--prompt-len", "20"])
    out = capsys.readouterr().out
    assert f"arch={cfg.name}" in out and "runner=TransformerRunner" in out
