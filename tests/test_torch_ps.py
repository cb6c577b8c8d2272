"""The port's parameter-server trainer and LSTM language model
(``repro_torch.ps``) against the JAX package's (``repro.ps``), every task on
the CPU: the three §4.4 modes over 12 steps of ``linear_model`` (losses and
final variables within 1e-4 relative of the reference's largest
magnitude: the reference's variables drift to float64 and sync averages in
arrival order), the full and sampled-softmax LM (one step's loss and every
gradient, then 3 sync steps), Save/Restore across the two packages, and a
straggler check that reads no clock (the straggler waits on an event).

Batches come from ``np.random.default_rng((seed, w, s))`` per worker and
step, so every worker thread draws the same batch in both packages
whatever the threads' interleaving."""

import threading
import time

import numpy as np
import pytest
import torch

import repro.core.ops  # noqa: F401
import repro.core.partition  # noqa: F401
import repro.core.queues  # noqa: F401
import repro.core.variables  # noqa: F401
from repro.core import cluster as r_cluster
from repro.core import graph as r_graph
from repro.core import session as r_session
from repro.ps import lm as r_lm
from repro.ps import training as r_tr
from repro_torch.core import cluster as t_cluster
from repro_torch.core import graph as t_graph
from repro_torch.core import session as t_session
from repro_torch.ps import lm as t_lm
from repro_torch.ps import training as t_tr
import torch_cpu  # noqa: F401  (one torch thread)

TOL = 1e-4
W_TRUE = np.random.default_rng(0).normal(0, 1, (16, 8)).astype(np.float32)
# backup mode: worker 0 sleeps at step 0 (straggler_every 100) long enough
# that the other three carry every step, in both packages
STRAGGLE_S = 1.0


def batch_fn(w, s, seed=0):
    x = np.random.default_rng((seed, w, s)).normal(0, 1, (32, 16)).astype(
        np.float32)
    return x, (x @ W_TRUE).argmax(-1)


PKGS = {
    "ref": (r_graph.Graph, r_cluster.Cluster, r_tr, r_lm),
    "port": (t_graph.Graph,
             lambda **jobs: t_cluster.Cluster(device="cpu", **jobs),
             t_tr, t_lm),
}


def host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def close(port, ref, tol=TOL):
    """Within ``tol`` of ref's largest magnitude; returns the relative
    error."""
    p, r = host(port).astype(np.float64), np.asarray(ref, np.float64)
    assert p.shape == r.shape
    err = float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-30))
    assert err <= tol, err
    return err


def variables(cl, names):
    out = {}
    for task in cl.tasks.values():
        for n in task.var_store.names():
            out[n] = host(task.var_store.read(n))
    return [out[n] for n in names]


def trainer(pkg, mode, n_workers, backup=0, strag=0.0, every=0):
    Graph, Cluster, tr, _ = PKGS[pkg]
    g = Graph()
    cl = Cluster(ps=2, worker=n_workers)
    model = tr.linear_model(g, 16, 8, n_shards=2)
    return cl, tr.PSTrainer(model, cl, mode=mode, n_workers=n_workers,
                            backup_workers=backup, lr=0.5, straggler_s=strag,
                            straggler_every=every)


MODES = [("sync", 1, 0, 0.0), ("sync", 4, 0, 0.0), ("async", 1, 0, 0.0),
         ("backup", 4, 1, STRAGGLE_S)]


@pytest.mark.parametrize("mode,n,backup,strag", MODES,
                         ids=["sync1", "sync4", "async1", "backup4"])
def test_modes_vs_reference(mode, n, backup, strag):
    """12 steps: losses and the final variables within 1e-4 of the
    reference; the loss falls; the port's variables stay float32 and live
    on the PS tasks."""
    runs = {}
    for pkg in ("ref", "port"):
        cl, tr = trainer(pkg, mode, n, backup, strag, 100 if strag else 0)
        stats = tr.train(12, batch_fn)
        runs[pkg] = (stats, variables(cl, ["w0", "w1"]), tr, cl)
    (rs, rv, _, _), (ps, pv, tr, cl) = runs["ref"], runs["port"]
    errs = [close(ps.losses, rs.losses)] + [close(p, r) for p, r in
                                            zip(pv, rv)]
    assert max(errs) <= TOL
    assert np.mean(ps.losses[-4:]) < np.mean(ps.losses[:4])
    assert {h.op.assigned_device for h in tr.model.var_handles} == \
        {"ps:0", "ps:1"}
    for task in cl.tasks.values():
        for name in task.var_store.names():
            assert task.var_store.read(name).dtype == torch.float32
    if mode == "backup":
        assert ps.discarded == rs.discarded


JOIN_S = 60.0


def straggled_trainer(mode, backup):
    """A 4-worker trainer after one step that builds every plan, whose
    worker 0 straggles at the next ``train``'s first step until the
    returned event is set (``_maybe_straggle`` patched: a wait on the
    event, not a sleep), and a counter of each worker's finished replica
    runs in that call (``session.run`` wrapped)."""
    _, tr = trainer("port", mode, 4, backup=backup)
    tr.train(1, batch_fn)
    gate = threading.Event()
    ran = {w: threading.Event() for w in range(4)}
    feeds = {id(rep[0]): w for w, rep in enumerate(tr.replicas)}

    def straggle(w, step):
        if w == 0 and step == 0:
            assert gate.wait(JOIN_S), "the straggler was never released"

    run = tr.session.run

    def counted(fetches, feed_dict=None, *a, **kw):
        out = run(fetches, feed_dict, *a, **kw)
        for ph in feed_dict or {}:
            if id(ph) in feeds:
                ran[feeds[id(ph)]].set()
        return out

    tr._maybe_straggle = straggle
    tr.session.run = counted
    return tr, gate, ran


def train_in_thread(tr, steps):
    """``tr.train(steps)`` on a thread of its own; (thread, result box)."""
    box = {}
    t = threading.Thread(target=lambda: box.update(
        stats=tr.train(steps, batch_fn)), daemon=True)
    t.start()
    return t, box


def test_backup_beats_sync_under_straggle():
    """Worker 0 straggles in the first measured step until an event is
    set. Backup (one backup worker) never waits for it: its 4 steps
    return while the event is still unset. Sync waits: once the other
    three workers have run their first step, that step is still pending
    while the event is unset; set, sync finishes its 4 steps. No clock:
    every wait is on an event or a join, each bounded by JOIN_S only so
    that a fault fails instead of hanging."""
    tr, gate, _ = straggled_trainer("backup", 1)
    t, box = train_in_thread(tr, 4)
    t.join(JOIN_S)
    assert not t.is_alive(), "backup waited for the straggler"
    assert not gate.is_set()
    assert len(box["stats"].step_times) == 1 + 4
    gate.set()

    tr, gate, ran = straggled_trainer("sync", 0)
    t, box = train_in_thread(tr, 4)
    for w in (1, 2, 3):
        assert ran[w].wait(JOIN_S), f"worker {w} never ran its step"
    assert t.is_alive() and len(tr.stats.step_times) == 1, \
        "sync finished a step without the straggler"
    gate.set()
    t.join(JOIN_S)
    assert not t.is_alive()
    assert len(box["stats"].step_times) == 1 + 4


LM = dict(vocab=512, d=16, unroll=2, n_ps=2)


def lm_run(pkg, softmax, steps):
    Graph, Cluster, tr, lm = PKGS[pkg]
    g = Graph()
    cl = Cluster(ps=2, worker=1)
    model = lm.lstm_lm_model(g, softmax=softmax, n_sampled=16, **LM)
    trn = tr.PSTrainer(model, cl, mode="sync", n_workers=1, lr=0.5)
    batches = lm.lm_batch_fn(LM["vocab"], 8, LM["unroll"])
    x, y, loss, grads = trn.replicas[0]
    xv, yv = batches(0, 0)
    first = trn.session.run([loss] + grads, {x: xv, y: yv})
    stats = trn.train(steps, batches)
    names = [h.op.attrs["var_name"] for h in model.var_handles]
    return first, stats.losses, variables(cl, names)


@pytest.mark.parametrize("softmax", ["full", "sampled"])
def test_lstm_lm_vs_reference(softmax):
    """The LM (vocab 512, d 16, unroll 2, two PS tasks): one step's loss
    and each of its 11 gradients (embedding, 8 cell weights, 2 softmax
    shards), then 3 sync steps' losses and every
    variable, within 1e-4 of the reference."""
    ref, port = lm_run("ref", softmax, 3), lm_run("port", softmax, 3)
    assert len(port[0]) == 1 + 1 + 8 + LM["n_ps"]
    for p, r in zip(port[0], ref[0]):
        close(p, r)
    close(port[1], ref[1])
    for p, r in zip(port[2], ref[2]):
        close(p, r)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_save_restore_across_packages(writer, tmp_path):
    """A checkpoint Save writes in one package restores in the other, the
    arrays' bytes equal; Restore + Assign re-materialises the variable."""
    init = np.random.default_rng(5).normal(0, 1, (6, 3)).astype(np.float32)
    path = str(tmp_path / "ckpt")
    reader = "ref" if writer == "port" else "port"
    out = {}
    for pkg in (writer, reader):
        Graph, Cluster, _, _ = PKGS[pkg]
        g = Graph()
        cl = Cluster(ps=1, worker=1)
        sess = (t_session if pkg == "port" else r_session).Session(
            g, cl, default_device="worker:0")
        h = g.apply("Variable", var_name="emb", device="ps:0",
                    initial=init if pkg == writer else np.zeros_like(init))
        if pkg == writer:
            sess.run(g.apply("AssignAdd", h, g.constant(np.float32(0.5))))
            sess.run(g.apply("Save", h, path=path))
        else:
            restored = g.apply("Restore", path=path, tensor_name="emb",
                               device="ps:0")
            sess.run(g.apply("Assign", h, restored))
        out[pkg] = host(cl.tasks["ps:0"].var_store.read("emb"))
    assert out[reader].dtype == np.float32
    assert out[reader].tobytes() == out[writer].tobytes()
    assert np.load(path + ".npz")["emb"].tobytes() == (init + 0.5).tobytes()


def test_trainer_needs_a_card_unless_asked():
    """linear_model on a Cluster built without device= runs on the card,
    and without one the cluster raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; chip_smoke phase 16 runs there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_cluster.Cluster(ps=2, worker=1)
    start = time.perf_counter()
    cl, tr = trainer("port", "async", 1)
    tr.train(1, batch_fn)
    assert time.perf_counter() - start < 30
    assert {t.device.type for t in cl.tasks.values()} == {"cpu"}
