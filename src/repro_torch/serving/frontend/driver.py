"""Async streaming driver: the engine's step loop as a long-lived service (a
copy of ``repro.serving.frontend.driver``, which the port may not import:
``import repro`` pulls in jax).

``AsyncEngineDriver`` owns an
:class:`~repro_torch.serving.engine.InferenceEngine`
and runs its step loop on a background thread, so requests can be
submitted *at any time* from asyncio code and each one streams its tokens
back the moment a step retires them — the serving shape the batch
``engine.run()`` driver cannot provide. Per request, ``submit`` returns a
:class:`TokenStream`: an async iterator of :class:`TokenEvent`\\ s
(token id + incrementally detokenized text), fed across the thread
boundary with ``loop.call_soon_threadsafe`` and closed when the engine
retires the request.

Equivalence contract (pinned by tests/test_torch_frontend.py): a request
streamed through the driver yields **byte-identical tokens** to the same
request run through ``engine.run()``. Tokens are appended by the very
same ``_append_token`` path (the driver only listens via the engine's
``on_token``/``on_finish`` hooks), and with ``arrival_step`` submissions
the thread loop reproduces ``run()``'s admission order and idle
clock-jumps exactly, so even the *scheduling stats* match the batch
driver on the same workload.

Admission is SLO-aware (``frontend/admission.py``): each ``submit``
consults the controller against the live queue depth and the engine's
realized TTFT window, raising :class:`ShedError` (→ HTTP 429 + Retry-
After) instead of queueing work that would blow the TTFT p95 target.
Graceful drain: ``drain()`` stops admissions (scheduler and driver
both), lets every admitted request retire, flushes and closes all
streams, then stops the thread.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import queue
import threading
import time
from collections import deque
from typing import NamedTuple

from repro_torch.serving.frontend.admission import AdmissionController

__all__ = ["AsyncEngineDriver", "TokenStream", "TokenEvent", "ShedError"]


class ShedError(RuntimeError):
    """Request refused by admission control (or a draining server).

    ``retry_after_s`` is always > 0: the wire layer maps it onto the
    HTTP ``Retry-After`` header of the 429 response.
    """

    def __init__(self, reason: str, retry_after_s: float = 0.1,
                 projected_ttft_s: float = 0.0):
        super().__init__(
            f"request shed ({reason}): retry after {retry_after_s:.3f}s")
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.projected_ttft_s = projected_ttft_s


class TokenEvent(NamedTuple):
    index: int                  # position in the request's output stream
    token: int                  # token id, byte-identical to engine.run()
    text: str                   # incremental detokenization of `token`
    # per-token logprobs ({"token_logprob": float, "top": [(id, lp), ...]})
    # when the request asked for them (SamplingParams.logprobs > 0)
    logprobs: dict | None = None


_DONE = object()


class TokenStream:
    """One request's async token stream (returned by ``submit``).

    Engine-thread side: ``_push`` / ``_finish`` / ``_abort`` enqueue onto
    the consumer's asyncio loop. Consumer side: ``async for ev in stream``
    yields :class:`TokenEvent`\\ s until the request retires. Tokens
    buffer unboundedly, so a slow (or absent) consumer never stalls the
    engine — backpressure is admission's job, not the stream's.
    """

    def __init__(self, request, loop, detokenize):
        self.request = request
        self._loop = loop
        self._detok = detokenize
        self._q: asyncio.Queue = asyncio.Queue()
        self._n = 0
        self.finished = False
        self.error: BaseException | None = None
        self.submit_wall = time.monotonic()
        self.first_token_wall: float | None = None

    # -- engine-thread side -------------------------------------------------

    def _push(self, tok: int, logprobs: dict | None = None) -> None:
        if self.first_token_wall is None:
            self.first_token_wall = time.monotonic()
        self._loop.call_soon_threadsafe(
            self._q.put_nowait, (int(tok), logprobs))

    def _finish(self) -> None:
        self._loop.call_soon_threadsafe(self._q.put_nowait, _DONE)

    def _abort(self, exc: BaseException) -> None:
        self.error = exc
        self._loop.call_soon_threadsafe(self._q.put_nowait, _DONE)

    # -- consumer side ------------------------------------------------------

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
        tok, logprobs = item
        ev = TokenEvent(self._n, tok, self._detok(tok), logprobs)
        self._n += 1
        return ev


def _default_detokenize(tok: int) -> str:
    """Placeholder incremental detokenizer: the repo serves raw token ids
    (there is no vocabulary file), so "text" is the id followed by a
    space. Real deployments pass ``detokenize=tokenizer.decode_piece``."""
    return f"{tok} "


class AsyncEngineDriver:
    """Background step loop + per-request async token streams.

    Usage::

        driver = AsyncEngineDriver(engine)          # or: async with ...
        await driver.start()
        stream = await driver.submit(Request(...))  # may raise ShedError
        async for ev in stream: ...
        await driver.drain()                        # graceful shutdown

    ``submit`` *before* ``start`` is allowed (arrivals queue up and run
    once the loop starts) — the admission tests rely on it to build a
    deterministic backlog. ``arrival_step`` schedules a submission on the
    engine's virtual clock exactly like ``engine.run(arrival_steps=...)``
    (the Poisson bench path); live traffic omits it.
    """

    def __init__(self, engine, *, admission: AdmissionController = None,
                 detokenize=None, idle_wait_s: float = 0.05):
        self.engine = engine
        self.admission = admission or AdmissionController()
        self.detokenize = detokenize or _default_detokenize
        self._idle_wait_s = idle_wait_s
        self._inbox: queue.Queue = queue.Queue()    # thread-safe handoff
        self._seq = itertools.count()               # FCFS tie-break
        self._streams: dict[int, TokenStream] = {}  # rid -> stream
        self._queued: set[int] = set()              # submitted, not running
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._done_event: asyncio.Event | None = None
        self._draining = False
        self._stopped = False
        self.error: BaseException | None = None
        # SSE streams whose client disconnected mid-stream (the HTTP
        # layer follows up with abort(), so the request stops computing)
        self.dropped_streams = 0
        # requests cancelled before retirement (client disconnect or an
        # explicit abort): their cache resources were released early
        self.aborted = 0
        # rids whose abort was requested but not yet applied by the
        # engine thread (drained between steps)
        self._abort_q: deque[int] = deque()

    # -- lifecycle ----------------------------------------------------------

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.aclose()

    async def start(self) -> None:
        if self._thread is not None:
            return
        self._loop = asyncio.get_running_loop()
        self._done_event = asyncio.Event()
        self.engine.on_token = self._on_token
        self.engine.on_finish = self._on_finish
        self.engine.sched.on_admit = self._on_admit
        self._thread = threading.Thread(
            target=self._run, name="engine-step-loop", daemon=True)
        self._thread.start()

    async def drain(self) -> None:
        """Graceful shutdown: stop admitting (driver and scheduler), let
        every admitted request retire and its stream close, then stop the
        step thread. Raises the engine error if the loop died.

        The scheduler's own drain flag is set by the step thread at exit,
        not here: requests already admitted by the front-end may still be
        in the handoff inbox, and they must reach ``sched.add`` (the
        ``submit`` gate above is what refuses *new* work)."""
        self._draining = True
        if self._thread is None:              # never started: nothing runs
            self.engine.sched.drain()
            self._stopped = True
            exc = RuntimeError("driver drained before start: "
                               "queued requests dropped")
            for stream in self._streams.values():
                stream._abort(exc)
            self._streams.clear()
            return
        self._inbox.put(None)                 # wake the thread
        await self._done_event.wait()
        if self.error is not None:
            raise self.error

    async def aclose(self) -> None:
        """Drain, join the thread, and detach from the engine (hooks
        removed, scheduler drain flag cleared) so the engine can keep
        being used as a plain batch driver afterwards."""
        try:
            await self.drain()
        finally:
            if self._thread is not None:
                self._thread.join(timeout=60)
            self._stopped = True
            self.engine.on_token = None
            self.engine.on_finish = None
            self.engine.sched.on_admit = None
            self.engine.sched.draining = False

    # -- queries ------------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Requests admitted by the front-end but not yet running (still
        in the handoff inbox or the scheduler's waiting queue)."""
        return len(self._queued)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- submission ---------------------------------------------------------

    async def submit(self, req, *, arrival_step: int | None = None
                     ) -> TokenStream:
        """Admit one request, or raise.

        Raises ``ShedError`` when draining or when admission control
        sheds (429 + retry signal at the HTTP layer), ``ValueError`` when
        the request can never fit (scheduler validation → HTTP 400).
        """
        if self.error is not None:
            raise self.error
        if self._draining or self._stopped:
            raise ShedError("draining", retry_after_s=1.0)
        self.engine.sched.validate(req)
        decision = self.admission.decide(self.queue_depth)
        if not decision.admit:
            self.admission.note_shed()
            raise ShedError(decision.reason, decision.retry_after_s,
                            decision.projected_ttft_s)
        loop = self._loop or asyncio.get_running_loop()
        stream = TokenStream(req, loop, self.detokenize)
        self._streams[req.rid] = stream
        self._queued.add(req.rid)
        self.admission.note_submitted(self.queue_depth - 1)
        t = -1 if arrival_step is None else int(arrival_step)
        self._inbox.put((t, next(self._seq), req))
        return stream

    def abort(self, rid: int) -> None:
        """Cancel an in-flight request (thread-safe, from any thread or
        the event loop). Applied by the engine thread *between* steps:
        the request stops computing, its blocks / host slots are released
        immediately, and its stream closes. A no-op for unknown or
        already-retired rids."""
        self._inbox.put(("abort", rid))

    def _apply_abort(self, pending: list, rid: int) -> None:
        """Engine-thread side of ``abort``: runs between steps."""
        cancelled = False
        for i, (_, _, req) in enumerate(pending):
            if req.rid == rid:            # never reached the scheduler
                pending.pop(i)
                heapq.heapify(pending)
                cancelled = True
                break
        else:
            cancelled = self.engine.abort(rid)
        self._queued.discard(rid)
        stream = self._streams.pop(rid, None)
        if stream is not None:
            stream._finish()
        if cancelled or stream is not None:
            self.aborted += 1
            self.admission.note_completed()

    # -- engine-thread callbacks (fire inside engine.step) -------------------

    def _on_admit(self, slot, req) -> None:
        if req.rid in self._queued:           # not a preemption re-admit
            self._queued.discard(req.rid)
            self.admission.note_admit(time.monotonic())

    def _on_token(self, req, tok, logprobs=None) -> None:
        stream = self._streams.get(req.rid)
        if stream is None:
            return
        first = stream.first_token_wall is None
        stream._push(tok, logprobs)
        if first:
            self.admission.note_ttft(
                stream.first_token_wall - stream.submit_wall)

    def _on_finish(self, req) -> None:
        stream = self._streams.pop(req.rid, None)
        if stream is not None:
            stream._finish()
            self.admission.note_completed()

    # -- the step loop (background thread) -----------------------------------

    def _run(self) -> None:
        eng = self.engine
        pending: list[tuple[int, int, object]] = []   # (step, seq, req)
        try:
            while True:
                # pull submissions; block only when there is nothing else
                # to do and we are not waiting on a scheduled arrival
                block = not eng.sched.has_work and not pending \
                    and not self._draining
                try:
                    while True:
                        item = self._inbox.get(
                            block=block, timeout=self._idle_wait_s)
                        block = False
                        if item is None:              # None = wake-up ping
                            continue
                        if item[0] == "abort":
                            self._abort_q.append(item[1])
                            continue
                        heapq.heappush(pending, item)
                except queue.Empty:
                    pass
                # cancellations apply between steps, before this tick's
                # admissions, so an aborted request never re-enters a plan
                while self._abort_q:
                    self._apply_abort(pending, self._abort_q.popleft())
                # admit every arrival due on the virtual clock, in
                # submission order — the same order engine.run() uses
                while pending and pending[0][0] <= eng.step_count:
                    _, _, req = heapq.heappop(pending)
                    eng.sched.add(req)
                    eng._note_arrival(req)
                if eng.sched.has_work:
                    if not eng.step():
                        raise RuntimeError(
                            "engine stuck: scheduler made no progress "
                            "with work pending")
                elif pending:
                    # idle with only future arrivals: jump the clock,
                    # exactly like engine.run()
                    eng.step_count = pending[0][0]
                elif self._draining:
                    eng.sched.drain()         # refuse work past this point
                    break                     # drained: all streams closed
        except BaseException as e:            # noqa: BLE001 — report, don't die
            self.error = e
            for stream in list(self._streams.values()):
                stream._abort(e)
            self._streams.clear()
        finally:
            self._stopped = True
            if self._loop is not None and self._done_event is not None:
                self._loop.call_soon_threadsafe(self._done_event.set)
