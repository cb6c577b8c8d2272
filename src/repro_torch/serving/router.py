"""Data-parallel replica routing with a shared prefix index (port of
``repro.serving.router``).

``ReplicaRouter`` puts N :class:`~repro_torch.serving.engine.InferenceEngine`
replicas — each with its own :class:`AsyncEngineDriver` step-loop thread
— behind one admission queue. Replicas constructed with a common
:class:`~repro_torch.serving.kv_cache.SharedPrefixIndex` share the content-hash
prefix cache across the fleet: blocks one replica hashed are adopted by
any replica's admission through the existing host-copy path, so a prompt
prefix is prefilled at most once *per fleet*, not once per replica.

Routing policy (deterministic, so the replica-equivalence harness in
tests/test_torch_router.py can pin dp∈{1,2,3} byte-for-byte): each request goes
to the replica with the **least outstanding tokens** (sum of
``len(prompt) + max_new`` over its unfinished assignments), ties broken
by lowest replica index; requests are considered strictly in submission
order (FCFS). With submissions made before ``start()`` — the harness
shape, mirroring ``engine.run(arrival_steps=...)`` — the whole placement
is a pure function of the workload.

Byte-identity argument (docs/multi-host.md): a request's tokens are a
function of (params, token prefix, sampling stream) only. All replicas
hold identical params; adopted KV equals recomputed KV (prefix caching's
qualification — KV is a pure function of the token prefix); and sampling
streams are keyed ``(seed, rid, len(out))``, independent of placement,
step timing, preemption, or adoption. So *where* a request runs and *how
much* of its prefix was adopted cannot change its output — which is
exactly what lets one queue feed N replicas safely.

Disaggregated prefill/decode (``disaggregate=True``): the first
``n_prefill`` replicas take the prefill role, the rest decode. A request
is split into a 1-token probe on a prefill replica (prompt KV computed
and hash-registered there; the engine's stream-close publish barrier
commits every full block to the shared index before the probe's stream
ends) and a continuation on a decode replica carrying ``out=[t1]`` — the
preemption-recompute shape, which the scheduler already replays
byte-identically. The continuation's admission adopts the published
prompt blocks, so the decode replica starts decode-ready without
recomputing prefill: the KV handoff unit is the hashed block, moved
through the shared index's host pool.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time

import numpy as np

from repro_torch.serving.frontend.admission import AdmissionController
from repro_torch.serving.frontend.driver import (AsyncEngineDriver, ShedError,
                                           TokenEvent)
from repro_torch.serving.scheduler import Request

__all__ = ["ReplicaRouter", "RouterStream"]

_DONE = object()


class RouterStream:
    """One request's async token stream as seen through the router.

    Mirrors :class:`~repro_torch.serving.frontend.driver.TokenStream`'s
    consumer surface (``async for ev in stream`` yielding
    :class:`TokenEvent`), fed by the router's per-request forwarding task
    on the same event loop — in disaggregated mode the events of both
    phases arrive here as one seamless, contiguously indexed stream.
    """

    def __init__(self, request):
        self.request = request
        self._q: asyncio.Queue = asyncio.Queue()
        self.finished = False
        self.error: BaseException | None = None
        self.submit_wall = time.monotonic()
        self.first_token_wall: float | None = None

    def _put(self, ev: TokenEvent) -> None:
        self._q.put_nowait(ev)

    def _close(self, exc: BaseException | None = None) -> None:
        if exc is not None and self.error is None:
            self.error = exc
        self._q.put_nowait(_DONE)

    def __aiter__(self):
        return self

    async def __anext__(self) -> TokenEvent:
        if self.finished:
            raise StopAsyncIteration
        item = await self._q.get()
        if item is _DONE:
            self.finished = True
            if self.error is not None:
                raise self.error
            raise StopAsyncIteration
        return item


def _phase1(req: Request) -> Request:
    """The 1-token prefill probe: same rid (sampling streams are keyed
    (seed, rid, counter), so token 0 is drawn from the same stream
    position the colocated run uses), same prompt, ``max_new=1``.

    Stop sequences are host-side only (they never shape the sampled
    token), so they are stripped whenever the colocated run would not
    check them at token 1 (``min_new >= 2`` gates the check) — kept
    otherwise, so a token-1 stop match lands exactly like colocated."""
    if req.min_new >= 2:
        sampling = dataclasses.replace(req.sampling, stop=())
        min_new = 0
    else:
        sampling = req.sampling
        min_new = req.min_new
    return Request(req.prompt, max_new=1, sampling=sampling,
                   eos_id=req.eos_id, min_new=min_new, rid=req.rid)


def _phase2(req: Request, t1: int, stop_hit: bool) -> Request:
    """The decode continuation: the original request with ``out=[t1]``
    pre-filled — byte-identical to a preemption victim re-admitted after
    its first token, a shape the scheduler replays exactly (sampling
    counters continue at len(out); speculative recompute stops one short
    so the verify window realigns)."""
    cont = Request(req.prompt, max_new=req.max_new, sampling=req.sampling,
                   eos_id=req.eos_id, min_new=req.min_new, rid=req.rid)
    cont.out = [int(t1)]
    cont.stop_hit = stop_hit
    return cont


class ReplicaRouter:
    """N engine replicas behind one deterministic admission queue.

    ``engines`` are fully constructed replicas (same config/params; pass
    each the same ``shared_index`` for cross-replica prefix sharing —
    required for ``disaggregate``). The router builds one
    ``AsyncEngineDriver`` per replica on ``start()`` (fresh drivers per
    run: engines and the shared index persist, so prefix state carries
    across runs), and exposes the driver surface ``FrontendServer``
    expects: ``submit`` / ``abort`` / ``drain`` / ``aclose`` /
    ``queue_depth`` / ``draining`` / ``admission``.
    """

    def __init__(self, engines, *, admission: AdmissionController = None,
                 detokenize=None, disaggregate: bool = False,
                 n_prefill: int = 1):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        self.engines = list(engines)
        self.dp = len(self.engines)
        self.disaggregate = disaggregate
        if disaggregate:
            if self.dp < 2:
                raise ValueError("disaggregate needs dp >= 2 (at least "
                                 "one prefill and one decode replica)")
            if not 1 <= n_prefill < self.dp:
                raise ValueError(
                    f"n_prefill={n_prefill} must leave both roles "
                    f"populated with dp={self.dp}")
            if any(e.shared_index is None for e in self.engines):
                raise ValueError(
                    "disaggregate requires every replica to share a "
                    "SharedPrefixIndex: the prefill->decode KV handoff "
                    "unit is the published hashed block")
        self.n_prefill = n_prefill if disaggregate else 0
        self._prefill_ids = list(range(self.n_prefill)) or \
            list(range(self.dp))
        self._decode_ids = list(range(self.n_prefill, self.dp))
        self.shared_index = self.engines[0].shared_index
        self.admission = admission or AdmissionController(
            n_replicas=self.dp)
        self._detokenize = detokenize
        self.drivers: list[AsyncEngineDriver] | None = None
        # least-outstanding-tokens routing state (deterministic: mutated
        # only on the event loop, in submission / stream-close order)
        self._outstanding = [0] * self.dp
        self.routed = [0] * self.dp           # submissions per replica
        self.handoffs = 0                     # disagg phase-2 submissions
        self.dropped_streams = 0              # SSE disconnects (http.py)
        self.aborted = 0                      # abort() calls on live rids
        self._assigned: dict[int, int] = {}   # rid -> current replica
        self._fleet_queued: set[int] = set()  # fleet note_admit filter
        self._aborted: set[int] = set()
        self._tasks: dict[int, asyncio.Task] = {}
        self._draining = False

    # -- queries ------------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        if self.drivers is None:
            return 0
        return sum(d.queue_depth for d in self.drivers)

    @property
    def draining(self) -> bool:
        return self._draining

    def replica_stats(self, key: str) -> list:
        return [e.stats[key] for e in self.engines]

    def shared_stats(self) -> dict:
        return (self.shared_index.stats() if self.shared_index is not None
                else {})

    # -- lifecycle ----------------------------------------------------------

    def _ensure_drivers(self) -> None:
        if self.drivers is not None:
            return
        # per-replica controllers are deliberately permissive: shedding
        # is the *fleet* controller's decision (it knows the dp-scaled
        # drain rate); a replica refusing routed work would break FCFS
        self.drivers = [
            AsyncEngineDriver(
                e, admission=AdmissionController(max_queue=1 << 30),
                detokenize=self._detokenize)
            for e in self.engines]
        self._draining = False
        self._outstanding = [0] * self.dp
        self._assigned.clear()
        self._fleet_queued.clear()
        self._aborted.clear()

    async def start(self) -> None:
        self._ensure_drivers()
        for eng, drv in zip(self.engines, self.drivers):
            await drv.start()
            # fleet drain-rate estimator: fold every replica's waiting ->
            # running transitions into the shared controller (the driver
            # installed its own hook in start(); chain onto it)
            inner = eng.sched.on_admit

            def hook(slot, req, _inner=inner):
                _inner(slot, req)
                if req.rid in self._fleet_queued:
                    self._fleet_queued.discard(req.rid)
                    self.admission.note_admit(time.monotonic())
            eng.sched.on_admit = hook

    async def drain(self) -> None:
        """Graceful fleet shutdown: stop admitting, let every forwarding
        task finish (disagg continuations included — a probe mid-flight
        still gets its decode phase), then drain every driver."""
        self._draining = True
        if self._tasks:
            await asyncio.gather(*list(self._tasks.values()),
                                 return_exceptions=True)
        if self.drivers is not None:
            for drv in self.drivers:
                await drv.drain()

    async def aclose(self) -> None:
        try:
            await self.drain()
        finally:
            if self.drivers is not None:
                for drv in self.drivers:
                    await drv.aclose()
            self.drivers = None             # next run builds fresh drivers

    # -- routing ------------------------------------------------------------

    def _pick(self, ids: list[int]) -> int:
        return min(ids, key=lambda i: (self._outstanding[i], i))

    async def submit(self, req: Request, *,
                     arrival_step: int | None = None) -> RouterStream:
        """Admit one request to the fleet, or raise ``ShedError`` /
        ``ValueError`` exactly like ``AsyncEngineDriver.submit``."""
        if self._draining:
            raise ShedError("draining", retry_after_s=1.0)
        self._ensure_drivers()
        self.engines[0].sched.validate(req)   # replicas are identical
        decision = self.admission.decide(self.queue_depth)
        if not decision.admit:
            self.admission.note_shed()
            raise ShedError(decision.reason, decision.retry_after_s,
                            decision.projected_ttft_s)
        self.admission.note_submitted(self.queue_depth)
        self._fleet_queued.add(req.rid)
        stream = RouterStream(req)
        if self.disaggregate:
            task = asyncio.ensure_future(
                self._run_disagg(req, stream, arrival_step))
        else:
            task = asyncio.ensure_future(
                self._run_colocated(req, stream, arrival_step))
        self._tasks[req.rid] = task
        task.add_done_callback(
            lambda _t, rid=req.rid: self._tasks.pop(rid, None))
        # yield once so the forwarding task reaches its inner submit now:
        # routing and driver handoff stay in submission order (FCFS)
        await asyncio.sleep(0)
        return stream

    def abort(self, rid: int) -> None:
        """Cancel an in-flight request fleet-wide (no-op for unknown or
        retired rids). Disaggregated requests between phases skip their
        decode phase; mid-phase ones abort on their current replica."""
        if rid in self._tasks and rid not in self._aborted:
            self.aborted += 1
        self._aborted.add(rid)
        i = self._assigned.get(rid)
        if i is not None and self.drivers is not None:
            self.drivers[i].abort(rid)

    def _note_first_token(self, stream: RouterStream) -> None:
        if stream.first_token_wall is None:
            stream.first_token_wall = time.monotonic()
            self.admission.note_ttft(
                stream.first_token_wall - stream.submit_wall)

    # -- forwarding tasks ----------------------------------------------------

    async def _run_colocated(self, req, stream, arrival_step) -> None:
        i = self._pick(list(range(self.dp)))
        cost = len(req.prompt) + req.max_new
        self._outstanding[i] += cost
        self.routed[i] += 1
        self._assigned[req.rid] = i
        try:
            inner = await self.drivers[i].submit(
                req, arrival_step=arrival_step)
            async for ev in inner:
                self._note_first_token(stream)
                stream._put(ev)
            stream._close()
        except BaseException as e:            # noqa: BLE001 — stream carries it
            stream._close(e)
        finally:
            self._outstanding[i] -= cost
            self._assigned.pop(req.rid, None)
            self._aborted.discard(req.rid)
            self.admission.note_completed()

    async def _run_disagg(self, req, stream, arrival_step) -> None:
        try:
            p1 = _phase1(req)
            i = self._pick(self._prefill_ids)
            cost1 = len(p1.prompt) + 1
            self._outstanding[i] += cost1
            self.routed[i] += 1
            self._assigned[req.rid] = i
            first = None
            try:
                inner = await self.drivers[i].submit(
                    p1, arrival_step=arrival_step)
                async for ev in inner:
                    first = ev
                    self._note_first_token(stream)
                    stream._put(ev)
            finally:
                self._outstanding[i] -= cost1
            if first is None or req.rid in self._aborted:
                stream._close()               # aborted during the probe
                return
            cont = _phase2(req, first.token, p1.stop_hit)
            if cont.done:                     # eos / stop / max_new == 1
                stream._close()
                return
            j = self._pick(self._decode_ids)
            cost2 = len(req.prompt) + req.max_new
            self._outstanding[j] += cost2
            self._assigned[req.rid] = j
            self.handoffs += 1
            try:
                # the probe's stream closed => its publish barrier ran:
                # every full prompt block is committed to the shared
                # index, so this admission adopts them and starts
                # decode-ready (no prefill recompute on the decode side)
                inner2 = await self.drivers[j].submit(cont)
                async for ev in inner2:
                    stream._put(TokenEvent(ev.index + 1, ev.token,
                                           ev.text, ev.logprobs))
            finally:
                self._outstanding[j] -= cost2
            stream._close()
        except BaseException as e:            # noqa: BLE001 — stream carries it
            stream._close(e)
        finally:
            self._assigned.pop(req.rid, None)
            self._aborted.discard(req.rid)
            self.admission.note_completed()

    # -- batch driver (the harness / bench shape) ----------------------------

    def run(self, requests: list[Request],
            arrival_steps: list[int] | None = None) -> dict[int, np.ndarray]:
        """Serve ``requests`` to completion through the fleet, mirroring
        ``engine.run()``: all submissions land before the step loops
        start (deterministic placement), ``arrival_steps`` schedules each
        request on its replica's virtual clock. Returns {rid: tokens}."""
        return asyncio.run(self._run_batch(requests, arrival_steps))

    async def _run_batch(self, requests, arrival_steps):
        if arrival_steps is None:
            arrival_steps = [0] * len(requests)
        self._ensure_drivers()
        streams = [await self.submit(r, arrival_step=t)
                   for r, t in zip(requests, arrival_steps)]
        await self.start()

        async def pull(s):
            return [ev.token async for ev in s]

        outs = await asyncio.gather(*(pull(s) for s in streams))
        await self.aclose()
        return {r.rid: np.asarray(toks, np.int32)
                for r, toks in zip(requests, outs)}
