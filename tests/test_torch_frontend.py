"""The port's streaming front end on the CPU at glm4 smoke size.

Against the JAX package, on the same inputs: ``AdmissionController``
makes the same decisions with the same retry times and projections, and
``render_metrics`` / ``render_router_metrics`` render the same text for
the same engine stats, histograms and front-end state (the reference's
renderers are duck-typed, so both read one port engine).

Inside the port, the reference's contract (tests/test_frontend.py): a
request streamed through ``AsyncEngineDriver`` gives the tokens
``engine.run()`` gives (staggered arrivals with a full-prompt hit,
preemption, speculative k = 2, the full sampling pipeline) with the same
scheduling stats; shedding, FCFS, graceful drain, abort of pending and
running requests; and over HTTP: SSE, /health, /metrics, 400 / 404 /
429, a client disconnect that aborts its request, the sampling fields
and logprobs."""

import asyncio
import json
import random

import numpy as np
import pytest

from repro.serving.frontend import AdmissionController as JAdmission
from repro.serving.frontend import render_metrics as jax_render_metrics
from repro.serving.frontend.metrics import \
    render_router_metrics as jax_render_router_metrics
from repro_torch.config import get_config
from repro_torch.models.api import init_model
from repro_torch.serving import (InferenceEngine, ReplicaRouter, Request,
                                 SamplingParams, SharedPrefixIndex)
from repro_torch.serving.frontend import (AdmissionController,
                                          AsyncEngineDriver, FrontendServer,
                                          ShedError, render_metrics,
                                          render_router_metrics)
from repro_torch.serving.frontend.admission import MIN_RETRY_AFTER_S
import torch_cpu  # noqa: F401  (one torch thread)

RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def glm():
    cfg = get_config("glm4_9b", smoke=True)
    return cfg, init_model(cfg, 0, "cpu")


def _engine(glm, **kw):
    cfg, params = glm
    kw.setdefault("max_batch", 4)
    kw.setdefault("block_size", 16)
    kw.setdefault("max_len", 96)
    return InferenceEngine(cfg, device="cpu", params=params,
                           debug_invariants=True, **kw)


# ---------------------------------------------------------------------------
# AdmissionController and the renderers against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_admission_matches_reference(seed):
    """A random stream of TTFT samples, admissions, submits, sheds and
    completions: every decision (admit, reason, retry time, projection)
    and every counter equal the reference's."""
    rng = random.Random(seed)
    kw = dict(ttft_slo_p95_s=rng.choice([None, 0.5, 2.0]),
              max_queue=rng.randrange(0, 6), window=rng.randrange(2, 9),
              n_replicas=rng.randrange(1, 4))
    ours, ref = AdmissionController(**kw), JAdmission(**kw)
    t = 0.0
    for _ in range(200):
        op = rng.randrange(5)
        if op == 0:
            v = rng.random() * 3
            ours.note_ttft(v), ref.note_ttft(v)
        elif op == 1:
            t += rng.random()
            ours.note_admit(t), ref.note_admit(t)
        elif op == 2:
            d = rng.randrange(8)
            ours.note_submitted(d), ref.note_submitted(d)
        elif op == 3:
            ours.note_shed(), ref.note_shed()
        else:
            ours.note_completed(), ref.note_completed()
        depth = rng.randrange(8)
        assert ours.decide(depth).__dict__ == ref.decide(depth).__dict__
        assert ours.projected_ttft_p95(depth) == ref.projected_ttft_p95(depth)
        assert (ours.submitted, ours.shed, ours.completed, ours.queue_peak) \
            == (ref.submitted, ref.shed, ref.completed, ref.queue_peak)


def test_admission_reference_cases():
    """The reference's worked numbers: the SLO projection and retry time,
    the queue bound, the dp-scaled drain rate, the refusals."""
    adm = AdmissionController(ttft_slo_p95_s=0.001, max_queue=4)
    assert adm.decide(queue_depth=3).admit                # cold start
    adm = AdmissionController(max_queue=2)
    d = adm.decide(2)
    assert not d.admit and d.reason == "queue_full"
    assert d.retry_after_s >= MIN_RETRY_AFTER_S
    adm = AdmissionController(ttft_slo_p95_s=2.5)
    for _ in range(4):
        adm.note_ttft(2.0)
    for t in (10.0, 11.0, 12.0):
        adm.note_admit(t)
    shed = adm.decide(queue_depth=1)
    assert not shed.admit and shed.reason == "ttft_slo"
    assert shed.projected_ttft_s == pytest.approx(3.0)
    assert shed.retry_after_s == pytest.approx(0.5)
    two = AdmissionController(ttft_slo_p95_s=2.5, n_replicas=2)
    two._ttft, two._admit_marks = adm._ttft, adm._admit_marks
    assert two.decide(1).admit
    for bad in (dict(max_queue=-1), dict(n_replicas=0)):
        with pytest.raises(ValueError):
            AdmissionController(**bad)


def test_render_metrics_matches_reference(glm):
    """One port engine after a preempting, prefix-hitting run (and a
    driver's front-end state): the port's text equals the reference
    renderer's, and parses as Prometheus text."""
    eng = _engine(glm, max_batch=2, num_blocks=8)
    prompts = [RNG.integers(0, glm[0].vocab_size, 32).astype(np.int32)
               for _ in range(2)]
    eng.run([Request(p.copy(), max_new=20) for p in prompts + prompts[:1]])
    assert eng.stats["preemptions"] >= 1
    text = render_metrics(eng)
    assert text == jax_render_metrics(eng)
    _assert_prometheus_valid(text)
    assert "repro_frontend" not in text
    assert "repro_engine_swap_space_mib 0" in text
    drv = AsyncEngineDriver(eng)
    drv.admission.note_submitted(0)
    drv.admission.note_shed()
    drv.dropped_streams, drv.aborted = 1, 2
    text = render_metrics(eng, drv)
    assert text == jax_render_metrics(eng, drv)
    assert "repro_frontend_aborted_requests_total 2" in text
    # the fleet view over two replicas and a shared index
    shared = SharedPrefixIndex(num_slots=8)
    engines = [_engine(glm, shared_index=shared) for _ in range(2)]
    router = ReplicaRouter(engines)
    router.run([Request(prompts[0].copy(), max_new=3, rid=91000)])
    text = render_router_metrics(router)
    assert text == jax_render_router_metrics(router)
    _assert_prometheus_valid(text)
    assert "repro_shared_index_published_total 2" in text


# ---------------------------------------------------------------------------
# the driver against engine.run()
# ---------------------------------------------------------------------------


_SCHED_KEYS = ("steps", "tokens", "prefill_chunks", "prefill_tokens",
               "cache_hit_tokens", "preemptions", "cow_copies",
               "requests", "requests_done")


async def _stream_all(drv, reqs, arrivals):
    """Submit everything before the step thread starts, as engine.run()
    sees its arrivals up front: streams and stats must then match."""
    streams = [await drv.submit(r, arrival_step=t)
               for r, t in zip(reqs, arrivals)]
    await drv.start()

    async def pull(s):
        return [ev async for ev in s]

    events = await asyncio.gather(*(pull(s) for s in streams))
    await drv.drain()
    return events


def _stream_vs_run(make_engine, make, arrivals):
    twin = make_engine()
    want = twin.run(make(), arrival_steps=arrivals)
    eng = make_engine()
    drv = AsyncEngineDriver(eng)
    reqs = make()
    events = asyncio.run(_stream_all(drv, reqs, arrivals))
    for r, evs in zip(reqs, events):
        np.testing.assert_array_equal([e.token for e in evs], want[r.rid])
        assert [e.index for e in evs] == list(range(len(evs)))
        assert [e.text for e in evs] == [f"{e.token} " for e in evs]
    for k in _SCHED_KEYS:
        assert eng.stats[k] == twin.stats[k], k
    return eng, twin, drv


def test_stream_matches_engine_run(glm):
    """Staggered submissions with a full-prompt prefix hit (COW) and a
    temperature request."""
    cfg = glm[0]
    common = RNG.integers(0, cfg.vocab_size, 64).astype(np.int32)
    prompts = [common.copy(), common.copy(),
               RNG.integers(0, cfg.vocab_size, 32).astype(np.int32),
               RNG.integers(0, cfg.vocab_size, 32).astype(np.int32)]
    temp = SamplingParams(temperature=0.9, top_k=16, seed=3)

    def make():
        return [Request(p.copy(), max_new=6,
                        sampling=temp if i == 3 else SamplingParams(),
                        rid=61000 + i) for i, p in enumerate(prompts)]

    eng, _, drv = _stream_vs_run(lambda: _engine(glm), make, [0, 3, 3, 6])
    assert eng.stats["cache_hit_tokens"] > 0
    assert drv.admission.completed == 4 and drv.admission.shed == 0


@pytest.mark.parametrize("case", ["preempt", "swap", "full", "spec"])
def test_stream_equivalence(glm, case):
    """A preemption victim (recompute or swap), the full sampling pipeline
    and speculative k = 2 stream what engine.run() gives."""
    cfg, params = glm
    prompts = [RNG.integers(0, cfg.vocab_size, 32).astype(np.int32)
               for _ in range(2)]
    kw, sp, arrivals = {}, SamplingParams(), [0, 0]
    if case in ("preempt", "swap"):
        kw = dict(max_batch=2, num_blocks=8)
        if case == "swap":
            kw.update(swap_space_bytes=1 << 20, swap_policy="always")
    elif case == "full":
        sp = SamplingParams(temperature=0.9, top_p=0.85,
                            repetition_penalty=1.3, seed=4)
    else:
        kw = dict(max_batch=2, num_speculative_tokens=2, draft_params=params)
        arrivals = [0, 2]

    def make():
        return [Request(p.copy(), max_new=20 if kw.get("num_blocks") else 8,
                        sampling=sp, rid=62000 + i)
                for i, p in enumerate(prompts)]

    eng, twin, _ = _stream_vs_run(lambda: _engine(glm, **kw), make, arrivals)
    if case == "preempt":
        assert eng.stats["preemptions"] >= 1
    elif case == "swap":
        assert eng.stats["swap_preemptions"] >= 1
    elif case == "full":
        assert eng.stats["full_sampling_steps"] > 0
    else:
        assert eng.stats["spec_decodes"] == twin.stats["spec_decodes"] > 0
        assert eng.stats["spec_emitted"] == twin.stats["spec_emitted"]


# ---------------------------------------------------------------------------
# admission over the driver: saturation, FCFS, SLO shed, drain, abort
# ---------------------------------------------------------------------------


def test_queue_saturation_sheds_with_retry_signal(glm):
    prompts = [RNG.integers(0, glm[0].vocab_size, 16).astype(np.int32)
               for _ in range(3)]
    eng = _engine(glm, max_batch=1)
    adm = AdmissionController(max_queue=2)
    drv = AsyncEngineDriver(eng, admission=adm)

    async def go():
        s0 = await drv.submit(Request(prompts[0], max_new=4))
        s1 = await drv.submit(Request(prompts[1], max_new=4))
        with pytest.raises(ShedError) as ei:
            await drv.submit(Request(prompts[2], max_new=4))
        assert ei.value.reason == "queue_full" and ei.value.retry_after_s > 0
        assert drv.queue_depth == 2
        await drv.start()
        order = []

        async def pull(s):
            toks = [ev.token async for ev in s]
            order.append(s.request.rid)
            return toks

        outs = await asyncio.gather(pull(s0), pull(s1))
        await drv.aclose()
        return (s0, s1), order, outs

    (s0, s1), order, outs = asyncio.run(go())
    assert order == [s0.request.rid, s1.request.rid]      # strict FCFS
    assert s0.first_token_wall <= s1.first_token_wall
    assert all(len(t) == 4 for t in outs)
    assert (adm.submitted, adm.shed, adm.completed, adm.queue_peak) \
        == (2, 1, 2, 2)
    assert len(adm._ttft) == 2 and eng.hist["ttft_seconds"].count == 2


def test_slo_shed_and_drain_before_start(glm):
    eng = _engine(glm)
    adm = AdmissionController(ttft_slo_p95_s=2.5)
    for _ in range(3):
        adm.note_ttft(2.0)
    for t in (5.0, 6.0, 7.0):
        adm.note_admit(t)
    drv = AsyncEngineDriver(eng, admission=adm)
    prompt = RNG.integers(0, glm[0].vocab_size, 16).astype(np.int32)

    async def go():
        s0 = await drv.submit(Request(prompt.copy(), max_new=4))
        with pytest.raises(ShedError) as ei:
            await drv.submit(Request(prompt.copy(), max_new=4))
        assert ei.value.reason == "ttft_slo"
        assert ei.value.projected_ttft_s == pytest.approx(3.0)
        assert ei.value.retry_after_s == pytest.approx(0.5)
        await drv.drain()
        with pytest.raises(RuntimeError, match="drained before start"):
            await s0.__anext__()
        with pytest.raises(ShedError) as ei2:
            await drv.submit(Request(prompt.copy(), max_new=4))
        assert ei2.value.reason == "draining"

    asyncio.run(go())
    assert adm.shed == 1


def test_graceful_drain_retires_all_admitted(glm):
    prompts = [RNG.integers(0, glm[0].vocab_size, 32).astype(np.int32)
               for _ in range(3)]
    eng = _engine(glm, max_batch=2)
    drv = AsyncEngineDriver(eng)

    async def go():
        await drv.start()
        streams = [await drv.submit(Request(p, max_new=5)) for p in prompts]
        await drv.drain()
        assert drv.queue_depth == 0
        with pytest.raises(ShedError):
            await drv.submit(Request(prompts[0], max_new=1))
        assert eng.sched.draining
        outs = [[ev.token async for ev in s] for s in streams]
        assert all(s.finished for s in streams)
        await drv.aclose()
        return outs

    outs = asyncio.run(go())
    assert all(len(t) == 5 for t in outs)
    assert eng.stats["requests_done"] == 3 and drv.admission.completed == 3
    assert not eng.sched.draining and eng.on_token is None
    out = eng.run([Request(prompts[0].copy(), max_new=3)])
    assert len(next(iter(out.values()))) == 3


def test_driver_abort_cancels_pending_and_running(glm):
    """An abort before the loop starts (never reaches the engine) and one
    mid-stream (between steps): the survivor runs to completion, every
    block is freed."""
    prompts = [RNG.integers(0, glm[0].vocab_size, 16).astype(np.int32)
               for _ in range(3)]
    eng = _engine(glm, max_batch=1)
    drv = AsyncEngineDriver(eng)

    async def go():
        s0 = await drv.submit(Request(prompts[0].copy(), max_new=24))
        s1 = await drv.submit(Request(prompts[1].copy(), max_new=4))
        s2 = await drv.submit(Request(prompts[2].copy(), max_new=4))
        drv.abort(s2.request.rid)
        await drv.start()
        toks0 = []
        async for ev in s0:
            toks0.append(ev.token)
            if len(toks0) == 2:
                drv.abort(s0.request.rid)
        toks1 = [ev.token async for ev in s1]
        await drv.drain()
        return toks0, toks1

    toks0, toks1 = asyncio.run(go())
    assert len(toks1) == 4 and 2 <= len(toks0) < 24
    assert drv.aborted == 2 and eng.stats["aborts"] >= 1
    assert eng.bm.stats().blocks_in_use == 0
    eng.bm.check()


# ---------------------------------------------------------------------------
# HTTP (a stdlib client over asyncio.open_connection)
# ---------------------------------------------------------------------------


async def _http(port, raw: bytes):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(raw)
    await writer.drain()
    data = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, body = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    headers = {k.strip().lower(): v.strip() for k, v in
               (ln.split(":", 1) for ln in head.decode().split("\r\n")[1:]
                if ":" in ln)}
    return status, headers, body


def _post(path: str, payload) -> bytes:
    body = (payload if isinstance(payload, bytes)
            else json.dumps(payload).encode())
    return (f"POST {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def _get(path: str) -> bytes:
    return f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode()


def _sse_events(body: bytes):
    return [json.loads(ln[len("data: "):]) for ln in body.decode().split("\n")
            if ln.startswith("data: ") and ln != "data: [DONE]"]


def _assert_prometheus_valid(text: str):
    """Every sample line parses; each histogram series (a family and its
    labels but ``le``) has cumulative buckets, the +Inf one == _count."""
    buckets: dict[str, list[float]] = {}
    counts: dict[str, float] = {}
    for ln in text.strip().split("\n"):
        if ln.startswith("#"):
            assert ln.startswith(("# HELP ", "# TYPE ")), ln
            continue
        name, val = ln.rsplit(" ", 1)
        v = float(val)
        if "_bucket{" in name:
            base, labels = name.split("_bucket{")
            labels = labels.rsplit("le=", 1)[0].rstrip(",")
            buckets.setdefault(f"{base}{{{labels}}}", []).append(v)
        elif "_count" in name:
            base, _, labels = name.partition("_count")
            counts[f"{base}{{{labels.strip('{}')}}}"] = v
    assert buckets, "no histograms rendered"
    for base, cum in buckets.items():
        assert cum == sorted(cum), f"{base} buckets not cumulative"
        assert cum[-1] == counts[base], f"{base} +Inf != _count"


def test_http_sse_health_metrics_and_errors(glm):
    prompt = [int(t) for t in RNG.integers(0, glm[0].vocab_size, 24)]
    want = next(iter(_engine(glm).run(
        [Request(np.asarray(prompt, np.int32), max_new=5)]).values()))
    eng = _engine(glm)
    drv = AsyncEngineDriver(eng)

    async def go():
        async with drv:
            srv = FrontendServer(drv, port=0)
            await srv.start()
            p = srv.port
            st, _, body = await _http(p, _get("/health"))
            assert st == 200 and json.loads(body)["status"] == "ok"
            st, hdr, body = await _http(
                p, _post("/generate", {"prompt": prompt, "max_new": 5}))
            assert st == 200
            assert hdr["content-type"].startswith("text/event-stream")
            events = _sse_events(body)
            toks = [e["token"] for e in events if "token" in e]
            done = [e for e in events if e.get("done")]
            assert len(done) == 1 and done[0]["n_tokens"] == 5
            st, _, body = await _http(p, _get("/metrics"))
            text = body.decode()
            assert st == 200
            _assert_prometheus_valid(text)
            for line in ("repro_engine_tokens_total 5",
                         "repro_engine_requests_done_total 1",
                         "repro_engine_ttft_seconds_count 1",
                         "repro_frontend_requests_submitted_total 1",
                         "repro_frontend_requests_shed_total 0",
                         "repro_frontend_queue_depth 0"):
                assert line in text, line
            assert (await _http(p, _get("/nope")))[0] == 404
            st, _, body = await _http(p, _post("/generate", b"not json"))
            assert st == 400 and b"invalid JSON" in body
            st, _, body = await _http(p, _post("/generate", {"prompt": []}))
            assert st == 400 and b"prompt" in body
            st, _, _ = await _http(
                p, _post("/generate", {"prompt": prompt, "max_new": 0}))
            assert st == 400
            await srv.aclose()
            return toks

    np.testing.assert_array_equal(asyncio.run(go()), want)


def test_http_shed_maps_to_429_and_drain_to_503(glm):
    eng = _engine(glm)
    drv = AsyncEngineDriver(eng, admission=AdmissionController(max_queue=0))

    async def go():
        srv = FrontendServer(drv, port=0)
        await srv.start()
        st, hdr, body = await _http(srv.port,
                                    _post("/generate", {"prompt": [1] * 8}))
        assert st == 429 and int(hdr["retry-after"]) >= 1
        err = json.loads(body)
        assert err["reason"] == "queue_full" and err["retry_after_s"] > 0
        await drv.drain()
        st, _, _ = await _http(srv.port,
                               _post("/generate", {"prompt": [1] * 8}))
        assert st == 503
        st, _, body = await _http(srv.port, _get("/health"))
        assert st == 503 and json.loads(body)["status"] == "draining"
        await srv.aclose()

    asyncio.run(go())
    assert drv.admission.shed == 1


def test_http_disconnect_aborts_request(glm):
    """A client that vanishes mid-stream cancels its request: generation
    stops early, its blocks are freed, the counters reach /metrics."""
    prompt = [int(t) for t in RNG.integers(0, glm[0].vocab_size, 16)]
    eng = _engine(glm)
    drv = AsyncEngineDriver(eng)

    async def go():
        async with drv:
            srv = FrontendServer(drv, port=0)
            await srv.start()
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           srv.port)
            writer.write(_post("/generate", {"prompt": prompt,
                                             "max_new": 64}))
            await writer.drain()
            got = b""
            while got.count(b"data: ") < 2:
                got += await reader.read(256)
            writer.close()
            await writer.wait_closed()
            for _ in range(200):
                if drv.aborted:
                    break
                await asyncio.sleep(0.05)
            st, _, body = await _http(srv.port, _get("/metrics"))
            assert st == 200
            await srv.aclose()
            return body.decode()

    text = asyncio.run(go())
    assert drv.dropped_streams == 1 and drv.aborted == 1
    assert eng.stats["aborts"] == 1 and eng.stats["tokens"] < 64
    for line in ("repro_frontend_aborted_requests_total 1",
                 "repro_frontend_dropped_streams_total 1",
                 "repro_engine_aborts_total 1"):
        assert line in text, line
    assert eng.bm.stats().blocks_in_use == 0


def test_http_sampling_fields_logprobs_and_stop(glm):
    prompt = [int(t) for t in RNG.integers(0, glm[0].vocab_size, 24)]
    want = next(iter(_engine(glm).run(
        [Request(np.asarray(prompt, np.int32), max_new=8)]).values()))
    stop = [int(want[2]), int(want[3])]
    eng = _engine(glm)
    drv = AsyncEngineDriver(eng)

    async def go():
        async with drv:
            srv = FrontendServer(drv, port=0)
            await srv.start()
            p = srv.port
            st, _, body = await _http(p, _post(
                "/generate", {"prompt": prompt, "max_new": 8,
                              "logprobs": 2}))
            assert st == 200
            events = [e for e in _sse_events(body) if "token" in e]
            assert [e["token"] for e in events] == list(want)
            for e in events:
                lp = e["logprobs"]
                assert lp["token_logprob"] <= 0.0 and len(lp["top"]) == 2
                assert lp["top"][0][1] >= lp["top"][1][1]
            st, _, body = await _http(p, _post(
                "/generate", {"prompt": prompt, "max_new": 8,
                              "stop": [stop]}))
            events = _sse_events(body)
            assert [e["token"] for e in events if "token" in e] \
                == list(want[:4])
            assert "logprobs" not in events[0]
            assert [e for e in events if e.get("done")][0]["n_tokens"] == 4
            st, _, body = await _http(p, _get("/metrics"))
            assert "repro_engine_stop_hits_total 1" in body.decode()
            for bad, word in (({"stop": [["x"]]}, b"stop"),
                              ({"top_p": 0.0}, b"top_p"),
                              ({"max_new": 4, "min_new": 9}, b"min_new")):
                st, _, body = await _http(
                    p, _post("/generate", {"prompt": prompt, **bad}))
                assert st == 400 and word in body
            await srv.aclose()

    asyncio.run(go())


@pytest.mark.parametrize("dp", [1, 2])
def test_serve_cli_http_and_fleet(dp, capsys):
    """The serve CLI's HTTP server (one engine, or a dp = 2 fleet sharing
    replica 0's weights) answers /generate and /health, then drains on its
    stop event; the synthetic workload through a disaggregated fleet."""
    from repro_torch.launch import serve
    ap_args = ["--arch", "glm4_9b", "--smoke", "--device", "cpu",
               "--http", "127.0.0.1:0", "--dp", str(dp),
               "--max-new", "3"]
    ns = serve.parse_args(ap_args)
    cfg = get_config("glm4_9b", smoke=True)
    if dp > 1:
        driver = serve.build_fleet(cfg, ns)
        engines = driver.engines
        assert engines[1].params is engines[0].params
    else:
        driver = AsyncEngineDriver(serve.build_engine(cfg, ns),
                                   admission=serve.build_controller(ns))
        engines = [driver.engine]

    async def go():
        stop, ready = asyncio.Event(), asyncio.Event()
        box = {}

        def on_ready(srv):
            box["port"] = srv.port
            ready.set()

        task = asyncio.ensure_future(serve.serve_http(
            driver, "127.0.0.1", 0, stop, on_ready))
        await ready.wait()
        st, _, body = await _http(box["port"], _get("/health"))
        assert st == 200 and json.loads(body)["replicas"] == dp
        st, _, body = await _http(box["port"], _post(
            "/generate", {"prompt": [3, 1, 4, 1, 5, 9, 2, 6], "max_new": 3}))
        assert st == 200
        assert len([e for e in _sse_events(body) if "token" in e]) == 3
        stop.set()
        await task

    asyncio.run(go())
    out = capsys.readouterr().out
    assert "[serve] http listening on 127.0.0.1:" in out
    assert "drained cleanly: requests_done=1 tokens=3" in out
    assert sum(e.stats["tokens"] for e in engines) == 3
    serve.main(["--arch", "glm4_9b", "--smoke", "--device", "cpu", "--dp",
                "2", "--disaggregate", "--requests", "4", "--max-new", "3",
                "--prompt-len", "40"])
    out = capsys.readouterr().out
    assert "disaggregate=True" in out and "handoffs=" in out
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--disaggregate"])
