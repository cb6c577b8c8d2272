"""The port's dataflow core (``repro_torch.core``) against the JAX package's
(``repro.core``): every case of ``tests/test_core_engine.py`` built in both
from the same numpy inputs (autodiff, variables across devices,
scatter-add, queue back-pressure, Switch/Merge, the Figure 3
part/gather/stitch with gradients, placement and colocation, Send/Recv in
the plan, concurrent steps, the step cache), the op table op by op
(forward, and the gradient of every differentiable op), and the reference
faults the port does not copy: a second fetch signature over partitioned
ops, a ``"ps:*"`` variable that moves between plans, float64 drift, and
Gather's out-of-range ids. Every port task runs on the CPU here
(``device="cpu"``). Values agree within 1e-5 of the reference's largest
magnitude (float32); gathers, stitches and integer ops exactly."""

import threading
import types

import numpy as np
import pytest
import torch

import repro.core.ops as r_ops
import repro.core.partition  # noqa: F401
import repro.core.queues  # noqa: F401
import repro.core.variables  # noqa: F401
from repro.core import cluster as r_cluster
from repro.core import control_flow as r_cf
from repro.core import gradients as r_grad
from repro.core import graph as r_graph
from repro.core import session as r_session
from repro_torch.core import cluster as t_cluster
from repro_torch.core import control_flow as t_cf
from repro_torch.core import gradients as t_grad
from repro_torch.core import graph as t_graph
from repro_torch.core import ops as t_ops
from repro_torch.core import session as t_session
import torch_cpu  # noqa: F401  (one torch thread)

REF = types.SimpleNamespace(
    name="ref", Graph=r_graph.Graph, Cluster=r_cluster.Cluster,
    Session=r_session.Session, gradients=r_grad.gradients, cond=r_cf.cond,
    DEAD=r_ops.DEAD)
PORT = types.SimpleNamespace(
    name="port", Graph=t_graph.Graph,
    Cluster=lambda **jobs: t_cluster.Cluster(device="cpu", **jobs),
    Session=t_session.Session, gradients=t_grad.gradients, cond=t_cf.cond,
    DEAD=t_ops.DEAD)
TOL = 1e-5


def session(P, **jobs):
    g = P.Graph()
    return g, P.Session(g, P.Cluster(**(jobs or {"ps": 2, "worker": 2})),
                        default_device="worker:0")


def host(v):
    """A fetched value as numpy (the port's are torch tensors)."""
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def same(port, ref, exact=False, tol=TOL):
    """port == ref: values within ``tol`` of ref's largest magnitude (or
    exactly), shapes equal; integer and boolean values always exactly."""
    if isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            same(p, r, exact, tol)
        return
    if ref is REF.DEAD:
        assert port is PORT.DEAD
        return
    p, r = host(port), np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    if exact or r.dtype.kind in "biu":
        np.testing.assert_array_equal(p, r)
        assert p.dtype.kind == r.dtype.kind
    else:
        scale = float(np.abs(r).max()) if r.size else 0.0
        np.testing.assert_allclose(p, r, rtol=0, atol=tol * max(scale, 1e-30))


def both(case, **kw):
    """Run ``case(P)`` on the reference and the port; compare."""
    ref, port = case(REF), case(PORT)
    same(port, ref, **kw)
    return port


# ---------------------------------------------------------------------------
# the cases of tests/test_core_engine.py
# ---------------------------------------------------------------------------


def test_autodiff_matmul_mean():
    def case(P):
        g, s = session(P)
        x = g.placeholder("x")
        w = g.apply("Variable", var_name="w",
                    initial=np.array([[1., 2.], [3., 4.]], np.float32),
                    device="ps:0")
        wv = g.apply("Read", w)
        loss = g.apply("ReduceMean",
                       g.apply("Square", g.apply("MatMul", x, wv)))
        (gw,) = P.gradients(loss, [wv])
        return s.run([loss, gw], {x: np.eye(2, dtype=np.float32)})

    lv, gv = both(case)
    assert float(lv) == pytest.approx(7.5)
    assert gv.dtype == torch.float32
    np.testing.assert_allclose(gv.numpy(), [[.5, 1.], [1.5, 2.]])


def test_variable_update_cross_device():
    def case(P):
        g, s = session(P)
        w = g.apply("Variable", var_name="w", initial=np.ones(3, np.float32),
                    device="ps:1")
        wv = g.apply("Read", w)
        upd = g.apply("AssignAdd", w, g.constant(np.float32(2.0)))
        s.run(upd)
        return s.run(wv)

    np.testing.assert_allclose(both(case).numpy(), 3.0 * np.ones(3))


def test_scatter_add_sparse_update():
    def case(P):
        g, s = session(P)
        w = g.apply("Variable", var_name="emb",
                    initial=np.zeros((4, 2), np.float32), device="ps:0")
        ids = g.placeholder("ids")
        rows = g.placeholder("rows")
        upd = g.apply("ScatterAdd", w, ids, rows)
        sub = g.apply("ScatterSub", w, ids, rows)
        s.run(upd, {ids: np.array([1, 1, 3, -1]),
                    rows: np.arange(8, dtype=np.float32).reshape(4, 2)})
        s.run(sub, {ids: np.array([0]), rows: np.ones((1, 2), np.float32)})
        return s.run(g.apply("Read", w))

    out = both(case, exact=True)
    np.testing.assert_allclose(out.numpy(), [[-1, -1], [2, 4], [0, 0],
                                             [10, 12]])


def test_queue_blocking_backpressure():
    def case(P):
        g, s = session(P)
        q = g.apply("FIFOQueue", queue_name="q", capacity=2,
                    device="worker:1")
        item = g.placeholder("item")
        enq = g.apply("Enqueue", q, item)
        deq = g.apply("Dequeue", q)
        size = g.apply("QueueSize", q)
        s.run(enq, {item: np.array(1.0)})
        s.run(enq, {item: np.array(2.0)})
        done = threading.Event()

        def producer():
            s.run(enq, {item: np.array(3.0)})
            done.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        assert not done.wait(0.2), "enqueue should block on a full queue"
        got = [s.run(deq)]
        assert done.wait(2.0), "enqueue should complete after dequeue"
        got += [s.run(size), s.run(deq), s.run(deq)]
        return got

    assert [float(v) for v in both(case, exact=True)] == [1.0, 2.0, 2.0, 3.0]


def test_queue_dequeue_many_and_close():
    def case(P):
        g, s = session(P)
        q = g.apply("FIFOQueue", queue_name="q", capacity=4,
                    device="worker:1")
        item = g.placeholder("item")
        enq = g.apply("Enqueue", q, item)
        for i in range(3):
            s.run(enq, {item: np.full(2, i, np.float32)})
        out = s.run(g.apply("DequeueMany", q, n=3))
        s.run(g.apply("QueueClose", q))
        return out

    same(both(case, exact=True), np.repeat(np.arange(3.), 2).reshape(3, 2))


@pytest.mark.parametrize("pred", [True, False])
def test_switch_merge_cond(pred):
    def case(P):
        g, s = session(P)
        p = g.placeholder("p")
        a = g.placeholder("a")
        r = P.cond(p, lambda t: t * g.constant(2.0),
                   lambda f: f + g.constant(100.0), [a])
        return s.run(r, {p: np.array(pred), a: np.array(3.0)})

    assert float(both(case)) == (6.0 if pred else 103.0)


def fig3(P, s, g, idv):
    """Figure 3: a two-way sharded embedding lookup with gradients."""
    e0 = g.apply("Variable", var_name="e0",
                 initial=np.arange(8.).reshape(4, 2).astype(np.float32),
                 device="ps:0")
    e1 = g.apply("Variable", var_name="e1",
                 initial=(np.arange(8.) + 100).reshape(4, 2).astype(
                     np.float32), device="ps:1")
    ids = g.placeholder("ids")
    shard = g.apply("FloorDiv", ids, g.constant(4))
    l0, l1 = g.apply("DynamicPartition", ids, shard, num_partitions=2)
    i0, i1 = g.apply("DynamicPartitionIndices", shard, num_partitions=2)
    r0 = g.apply("Read", e0)
    r1 = g.apply("Read", e1)
    g0 = g.apply("Gather", r0, l0)
    g1 = g.apply("Gather", r1, g.apply("Sub", l1, g.constant(4)))
    emb = g.apply("DynamicStitch", i0, i1, g0, g1, n=2)
    loss = g.apply("ReduceSum", g.apply("Mul", emb, emb))
    d0, d1 = P.gradients(loss, [r0, r1])
    return s.run([emb, d0, d1], {ids: idv})


def test_sharded_embedding_part_gather_stitch():
    """Figure 3, gradients included: the stitched rows bit for bit, the
    gradient lands only on touched rows (twice for a repeated id)."""
    idv = np.array([0, 5, 3, 4, 5])
    out, gv0, gv1 = both(lambda P: fig3(P, *session(P)[::-1], idv),
                         exact=True)
    np.testing.assert_array_equal(out.numpy()[:4], [[0, 1], [102, 103],
                                                    [6, 7], [100, 101]])
    np.testing.assert_array_equal(gv0.numpy().sum(axis=1), [2, 0, 0, 26])
    np.testing.assert_array_equal(gv1.numpy().sum(axis=1), [402, 820, 0, 0])


def test_placement_round_robin_and_colocation():
    def case(P):
        g, s = session(P)
        handles = [g.apply("Variable", var_name=f"v{i}",
                           initial=np.zeros(1, np.float32), device="ps:*")
                   for i in range(4)]
        reads = [g.apply("Read", h) for h in handles]
        s.run(reads)
        devs = [h.op.assigned_device for h in handles]
        for h, r in zip(handles, reads):
            assert r.op.assigned_device == h.op.assigned_device
        return devs

    ref, port = case(REF), case(PORT)
    assert port == ref and set(port) == {"ps:0", "ps:1"}, (port, ref)


def test_send_recv_inserted_for_cross_device_edges():
    """Send and Recv belong to the plan (the graph gains no ops) and the
    value crosses between the tasks' threads."""
    def case(P):
        g, s = session(P)
        a = g.apply("Variable", var_name="a",
                    initial=np.array([2.0], np.float32), device="ps:0")
        b = g.apply("Read", a)
        c = g.apply("Mul", b, g.constant(np.float32(3.0)))
        c.op.device = "worker:1"
        return g, s, c, s.run(c)

    _, _, _, ref = case(REF)
    g, s, c, port = case(PORT)
    same(port, ref)
    assert not [op for op in g.ops.values() if op.type in ("Send", "Recv")]
    (plan,) = s._plan_cache.values()
    types_by_dev = {d: [op.type for op in p.ops]
                    for d, p in plan.per_device.items()}
    assert "Send" in types_by_dev["ps:0"], types_by_dev
    assert "Recv" in types_by_dev["worker:1"], types_by_dev
    recvs = [op.outputs[0] for op in plan.per_device["worker:1"].ops
             if op.type == "Recv"]
    assert plan.per_device["worker:1"].inputs[c.op][0] in recvs
    assert [t.op.type for t in c.op.inputs] == ["Read", "Const"]


def test_concurrent_steps_shared_state():
    def case(P):
        g, s = session(P)
        w = g.apply("Variable", var_name="ctr",
                    initial=np.zeros(1, np.float32), device="ps:0")
        inc = g.apply("AssignAdd", w, g.constant(np.float32(1.0)))
        threads = [threading.Thread(target=lambda: s.run(inc), daemon=True)
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return s.run(g.apply("Read", w))

    assert float(both(case)[0]) == 16.0


def test_step_cache_reused():
    g, s = session(PORT)
    x = g.placeholder("x")
    y = g.apply("Mul", x, g.constant(2.0))
    assert float(s.run(y, {x: np.array(1.0)})) == 2.0
    n_plans = len(s._plan_cache)
    assert float(s.run(y, {x: np.array(2.0)})) == 4.0
    assert len(s._plan_cache) == n_plans  # same plan reused


# ---------------------------------------------------------------------------
# the op table, op by op
# ---------------------------------------------------------------------------

_R = np.random.default_rng(7)
_A = _R.normal(0, 1, (3, 4)).astype(np.float32)
_B = _R.normal(0, 1, (3, 4)).astype(np.float32)
_POS = (np.abs(_A) + 0.5).astype(np.float32)
_I = np.array([[7, -7, 5], [-5, 3, -3]])
_J = np.array([[2, 2, -3], [3, -2, 4]])
_IDS = np.array([2, -1, 0, 2])
_PART = np.array([1, 0, 2, 1, 0])

# op, inputs, attrs, exact
OPS = [
    ("Identity", [_A], {}, True),
    ("Add", [_A, _B[0]], {}, False),
    ("Sub", [_A, _B], {}, False),
    ("Mul", [_A, np.float32(3.0)], {}, False),
    ("Div", [_A, _POS], {}, False),
    ("Maximum", [_A, _B], {}, True),
    ("Pow", [_POS, _B], {}, False),
    ("FloorDiv", [_I, _J], {}, True),
    ("Mod", [_I, _J], {}, True),
    ("FloorDiv", [_A * 5, _B], {}, True),
    ("Mod", [_A * 5, _B], {}, False),
    ("Less", [_A, _B], {}, True),
    ("Greater", [_A, _B], {}, True),
    ("Equal", [_I, _J * 0 + 3], {}, True),
    ("UnbroadcastLike", [np.ones((2, 3, 4), np.float32), _A[:1]], {}, True),
    ("Neg", [_A], {}, True),
    ("Reciprocal", [_POS], {}, False),
    ("Exp", [_A], {}, False),
    ("Log", [_POS], {}, False),
    ("Tanh", [_A], {}, False),
    ("Sigmoid", [_A], {}, False),
    ("Relu", [_A], {}, True),
    ("ReluGrad", [_B, _A], {}, True),
    ("Sqrt", [_POS], {}, False),
    ("Square", [_A], {}, False),
    ("MatMul", [_A, _B.T.copy()], {}, False),
    ("Transpose", [_A], {}, True),
    ("Reshape", [_A], {"shape": (2, 6)}, True),
    ("ReshapeLike", [_A, np.zeros((6, 2))], {}, True),
    ("ReduceSum", [_A], {}, False),
    ("ReduceSum", [_A], {"axis": 0}, False),
    ("ReduceSum", [_A], {"axis": (0, 1), "keepdims": True}, False),
    ("ReduceMean", [_A], {"axis": -1}, False),
    ("ReduceMean", [_A], {"keepdims": True}, False),
    ("ReduceMax", [_A], {"axis": 1, "keepdims": True}, True),
    ("ReduceMax", [_A], {}, True),
    ("BroadcastLike", [_A[:, 0], _A], {"axis": 1}, True),
    ("MeanScale", [_A, _A], {"axis": 0}, False),
    ("AddN", [_A, _B, _A], {}, False),
    ("Softmax", [_A], {}, False),
    ("SoftmaxXent", [_A, np.array([0, 3, 1])], {}, False),
    ("SoftmaxXentGrad", [np.float32(2.0), _A, np.array([0, 3, 1])], {},
     False),
    ("Gather", [_A, _IDS], {}, True),
    ("Gather", [_A, _IDS.reshape(2, 2)], {}, True),
    ("ScatterAddGrad", [np.ones((4, 4), np.float32), _A, _IDS], {}, True),
    ("DynamicPartition", [_R.normal(0, 1, (5, 2)).astype(np.float32),
                          _PART], {"num_partitions": 3}, True),
    ("DynamicPartitionIndices", [_PART], {"num_partitions": 3}, True),
    ("DynamicStitch", [np.array([1, 3]), np.array([0, 2]), _A[:2], _B[:2]],
     {"n": 2}, True),
    ("Concat", [_A, _B], {"axis": 0}, True),
    ("Concat", [_A, _B[:, :2]], {}, True),
    ("ConcatGrad", [_A, _A[:, :1], _A[:, :3]], {"n": 2}, True),
]


def run_op(P, op, inputs, attrs):
    g, s = session(P, worker=1)
    phs = [g.placeholder(f"in{i}") for i in range(len(inputs))]
    out = g.apply(op, *phs, **attrs)
    outs = list(out) if isinstance(out, tuple) else [out]
    return s.run(outs, dict(zip(phs, inputs)))


@pytest.mark.parametrize("op,inputs,attrs,exact", OPS,
                         ids=[f"{o[0]}-{i}" for i, o in enumerate(OPS)])
def test_op_vs_reference(op, inputs, attrs, exact):
    """Each op's forward on the same inputs: numpy's meaning (Mod and
    FloorDiv follow the divisor's sign, negative ids count from the end,
    reductions take axis None and keepdims)."""
    same(run_op(PORT, op, inputs, attrs), run_op(REF, op, inputs, attrs),
         exact=exact)


def test_switch_and_merge_ops():
    def case(P):
        g, s = session(P, worker=1)
        d, p = g.placeholder("d"), g.placeholder("p")
        f, t = g.apply("Switch", d, p)
        m, n = g.apply("Merge", f, t)
        m2, n2 = g.apply("Merge", f, g.constant(np.float32(5.0)))
        return [s.run([f, t, m, n, m2, n2], {d: _A, p: np.array(v)})
                for v in (True, False)]

    ref, port = case(REF), case(PORT)
    same(port, ref, exact=True)
    assert port[0][3].dtype == torch.int64 and port[0][3].dim() == 0


# ops with a gradient function: the gradient of sum(op(x) * w) in each
# differentiable input
GRAD_OPS = [
    ("Identity", [_A], {}, [0]),
    ("Add", [_A, _B[0]], {}, [0, 1]),
    ("Sub", [_A, _B[:, :1]], {}, [0, 1]),
    ("Mul", [_A, _B], {}, [0, 1]),
    ("Div", [_A, _POS], {}, [0, 1]),
    ("Neg", [_A], {}, [0]),
    ("Exp", [_A], {}, [0]),
    ("Log", [_POS], {}, [0]),
    ("Tanh", [_A], {}, [0]),
    ("Sigmoid", [_A], {}, [0]),
    ("Relu", [_A], {}, [0]),
    ("Square", [_A], {}, [0]),
    ("MatMul", [_A, _B.T.copy()], {}, [0, 1]),
    ("Transpose", [_A], {}, [0]),
    ("Reshape", [_A], {"shape": (6, 2)}, [0]),
    ("ReduceSum", [_A], {"axis": 1}, [0]),
    ("ReduceMean", [_A], {"axis": 0, "keepdims": True}, [0]),
    ("ReduceMean", [_A], {}, [0]),
    ("AddN", [_A, _B], {}, [0, 1]),
    ("SoftmaxXent", [_A, np.array([0, 3, 1])], {}, [0]),
    ("Gather", [_A, _IDS], {}, [0]),
    ("DynamicPartition", [_A, np.array([1, 0, 1])], {"num_partitions": 2},
     [0]),
    ("DynamicStitch", [np.array([1, 3]), np.array([0, 2]), _A[:2], _B[:2]],
     {"n": 2}, [2, 3]),
    ("Concat", [_A, _B[:, :2]], {"axis": -1}, [0, 1]),
]


def run_grad(P, op, inputs, attrs, wrt):
    g, s = session(P, worker=1)
    phs = [g.placeholder(f"in{i}") for i in range(len(inputs))]
    out = g.apply(op, *phs, **attrs)
    outs = list(out) if isinstance(out, tuple) else [out]
    w = np.random.default_rng(1)
    loss = None
    for o in outs:
        shape = s.run(o, dict(zip(phs, inputs))).shape
        term = g.apply("ReduceSum", g.apply(
            "Mul", o, g.constant(w.normal(0, 1, tuple(shape)).astype(
                np.float32))))
        loss = term if loss is None else g.apply("Add", loss, term)
    grads = P.gradients(loss, [phs[i] for i in wrt])
    return s.run(grads, dict(zip(phs, inputs)))


@pytest.mark.parametrize("op,inputs,attrs,wrt", GRAD_OPS,
                         ids=[f"{o[0]}-{i}" for i, o in enumerate(GRAD_OPS)])
def test_op_gradient_vs_reference(op, inputs, attrs, wrt):
    """Each registered gradient builds the same values: the port's float32
    seed against the reference's float64 one, within 1e-5."""
    port = run_grad(PORT, op, inputs, attrs, wrt)
    same(port, run_grad(REF, op, inputs, attrs, wrt))
    for v in port:
        assert v.dtype == torch.float32, (op, v.dtype)


# ---------------------------------------------------------------------------
# the reference's faults, on the port only; each against the reference run
# where it is consistent (a fresh graph per signature)
# ---------------------------------------------------------------------------


def overlap(g):
    v = g.apply("Variable", var_name="v",
                initial=np.arange(4, dtype=np.float32).reshape(2, 2),
                device="ps:0")
    r = g.apply("Read", v)
    with g.device("worker:0"):
        mm = g.apply("MatMul", r, r)
    return r, mm


def test_fault1_overlapping_fetch_signatures_both_run():
    """The reference's partition rewrites op inputs in place, so a second
    plan reaching a partitioned op waits on the first plan's Recv; the
    port's plans keep their own input maps and both signatures run."""
    g, s = session(PORT)
    r, mm = overlap(g)
    first = s.run(mm)
    second = s.run([r, mm], timeout=10.0)
    refs = []
    for fetch in ("mm", "both"):
        rg, rs = session(REF)
        rr, rmm = overlap(rg)
        refs.append(rs.run(rmm if fetch == "mm" else [rr, rmm]))
    same([first, second], refs)


def test_fault2_ps_star_variable_keeps_its_task():
    """A plan that updates only w1 places it first; a later plan reading
    w0 and w1 must find the update (the reference round-robins each plan
    afresh, so ps:1 makes a second w1 of zeros). The reference run here
    places both variables in its first plan, where it is consistent."""
    def build(P):
        g, s = session(P)
        hs = [g.apply("Variable", var_name=f"w{i}",
                      initial=np.zeros(2, np.float32), device="ps:*")
              for i in range(2)]
        upd = g.apply("AssignAdd", hs[1], g.constant(np.float32(1.0)))
        reads = [g.apply("Read", h) for h in hs]
        return s, hs, upd, reads

    s, hs, upd, reads = build(PORT)
    s.run(upd)
    first = hs[1].op.assigned_device
    port = s.run(reads)
    assert hs[1].op.assigned_device == first
    assert hs[0].op.assigned_device != first
    tasks = s.cluster.tasks
    assert [n for d in tasks.values() for n in d.var_store.names()].count(
        "w1") == 1
    rs, _, rupd, rreads = build(REF)
    rs.run([rreads[0], rupd])
    same(port, rs.run(rreads), exact=True)
    np.testing.assert_array_equal(port[1].numpy(), [1, 1])


def test_fault3_buffers_stay_float32():
    """One sync step of linear_model: the port's variables stay float32;
    the reference's drift to float64 under numpy 2's promotion (its
    float64 gradient seed), with the same values within 1e-5."""
    from repro.ps import training as r_tr
    from repro_torch.ps import training as t_tr
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (8, 16)).astype(np.float32)
    y = rng.integers(0, 8, 8)
    out = {}
    for P, mod in ((REF, r_tr), (PORT, t_tr)):
        g = P.Graph()
        cl = P.Cluster(ps=2, worker=1)
        tr = mod.PSTrainer(mod.linear_model(g, 16, 8, 2), cl, mode="sync",
                           n_workers=1, lr=0.5)
        tr.train(2, lambda w, s: (x, y))
        out[P.name] = [cl.tasks[f"ps:{i}"].var_store.read(f"w{i}")
                       for i in range(2)]
    for v in out["port"]:
        assert v.dtype == torch.float32
    want = np.float64 if np.lib.NumpyVersion(np.__version__) >= "2.0.0" \
        else np.float32
    assert {v.dtype for v in out["ref"]} == {np.dtype(want)}
    same(out["port"], out["ref"])


def test_gather_out_of_range_raises_on_the_cpu():
    """On a CPU tensor Gather indexes as numpy does: an id out of range
    raises IndexError, as in the reference (on the card the kernel clamps
    it instead: tests/test_torch_training_cuda.py, chip_smoke phase 16a)."""
    outs = []
    for P in (REF, PORT):
        g, s = session(P, worker=1)
        ids = g.placeholder("ids")
        out = g.apply("Gather", g.constant(_A), ids)
        with pytest.raises(IndexError):
            s.run(out, {ids: np.array([0, 3])})
        outs.append(s.run(out, {ids: np.array([-3, 2])}))
    same(outs[1], outs[0], exact=True)


def test_device_timeout_names_the_device():
    """A device thread still blocked at the step's timeout raises
    TimeoutError naming its task, not a KeyError."""
    g, s = session(PORT)
    q = g.apply("FIFOQueue", queue_name="q", capacity=1, device="worker:1")
    with pytest.raises(TimeoutError, match="worker:1"):
        s.run(g.apply("Dequeue", q), timeout=0.3)
    s.run(g.apply("QueueClose", q))     # the blocked thread ends too


def test_cluster_defaults_to_the_card():
    """Without device= every task is on "cuda"; with no card that raises,
    with no fallback to the host. job_devices sets jobs apart."""
    if torch.cuda.is_available():
        cl = t_cluster.Cluster(ps=1, worker=1)
        assert {t.device.type for t in cl.tasks.values()} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_cluster.Cluster(worker=1)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            t_session.Session(t_graph.Graph())
    cl = t_cluster.Cluster(ps=1, worker=1, device="cpu",
                           job_devices={"ps": "cpu"})
    assert {t.device.type for t in cl.tasks.values()} == {"cpu"}
    with pytest.raises(ValueError, match="names no job"):
        t_cluster.Cluster(worker=1, device="cpu", job_devices={"ps": "cpu"})
