"""Stdlib-only asyncio HTTP layer for the streaming front-end (a copy of
``repro.serving.frontend.http``, which the port may not import: ``import
repro`` pulls in jax).

No web framework, no new runtime deps: a minimal HTTP/1.1 server on
``asyncio.start_server`` exposing exactly the surface a serving replica
needs behind a load balancer:

* ``POST /generate`` — JSON body, Server-Sent-Events response: one
  ``data: {"index", "token", "text"}`` event per generated token as the
  engine retires it, a final ``data: {"done": true, ...}`` summary, then
  ``data: [DONE]``. Sheds with ``429`` + ``Retry-After`` (SLO admission
  control), ``400`` on invalid bodies, ``503`` while draining.
* ``GET /health`` — JSON liveness/readiness (``200 ok`` serving,
  ``503 draining`` during graceful shutdown, so LBs stop routing here).
* ``GET /metrics`` — Prometheus text format (``frontend/metrics.py``).

Connections are ``Connection: close`` (one request per connection): the
SSE stream has no predeclared length, and keeping the parser trivial
keeps it auditable. A client that disconnects mid-stream **cancels** the
request: the driver's abort path releases its batch slot, KV blocks and
any host-swapped pages between engine steps, so abandoned work stops
consuming the token budget (docs/serving-frontend.md).

Request body schema (all but ``prompt`` optional; see docs/sampling.md
for field semantics)::

    {"prompt": [int, ...], "max_new": 16, "min_new": 0,
     "temperature": 0.0, "top_k": 0, "top_p": 1.0, "min_p": 0.0,
     "repetition_penalty": 1.0, "presence_penalty": 0.0,
     "frequency_penalty": 0.0, "logprobs": 0,
     "stop": [[int, ...], ...], "seed": 0, "eos_id": null}

With ``logprobs: n`` each SSE event carries a ``logprobs`` object:
``{"token_logprob": float, "top": [[id, lp], ...]}`` (top-n of the
post-penalty distribution the token was drawn from).
"""

from __future__ import annotations

import asyncio
import json
import math

import numpy as np

from repro_torch.serving.frontend import metrics as metrics_mod
from repro_torch.serving.frontend.driver import ShedError
from repro_torch.serving.scheduler import Request, SamplingParams

__all__ = ["FrontendServer"]

_MAX_BODY = 1 << 20
_MAX_HEADER_LINES = 100


def _response_head(status: int, reason: str, ctype: str, length: int | None,
                   extra: tuple[tuple[str, str], ...] = ()) -> bytes:
    lines = [f"HTTP/1.1 {status} {reason}",
             f"Content-Type: {ctype}",
             "Connection: close"]
    if length is not None:
        lines.append(f"Content-Length: {length}")
    lines += [f"{k}: {v}" for k, v in extra]
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


class _BadRequest(Exception):
    pass


async def _read_request(reader: asyncio.StreamReader):
    """Parse one request: (method, path, headers, body)."""
    line = await reader.readline()
    parts = line.decode("latin-1").rstrip("\r\n").split(" ")
    if len(parts) != 3:
        raise _BadRequest(f"malformed request line: {line!r}")
    method, path, _version = parts
    headers: dict[str, str] = {}
    for _ in range(_MAX_HEADER_LINES):
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    else:
        raise _BadRequest("too many header lines")
    try:
        n = int(headers.get("content-length", "0"))
    except ValueError as e:
        raise _BadRequest("bad Content-Length") from e
    if not 0 <= n <= _MAX_BODY:
        raise _BadRequest(f"body too large ({n} bytes)")
    body = await reader.readexactly(n) if n else b""
    return method, path.split("?", 1)[0], headers, body


def _parse_generate(body: bytes) -> Request:
    try:
        payload = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise _BadRequest(f"invalid JSON body: {e}") from e
    if not isinstance(payload, dict):
        raise _BadRequest("body must be a JSON object")
    prompt = payload.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and t >= 0 for t in prompt)):
        raise _BadRequest('"prompt" must be a non-empty list of token ids')
    stop = payload.get("stop", [])
    if (not isinstance(stop, list)
            or not all(isinstance(s, list) and s
                       and all(isinstance(t, int) and t >= 0 for t in s)
                       for s in stop)):
        raise _BadRequest(
            '"stop" must be a list of non-empty token-id lists')
    try:
        sp = SamplingParams(
            temperature=float(payload.get("temperature", 0.0)),
            top_k=int(payload.get("top_k", 0)),
            seed=int(payload.get("seed", 0)),
            top_p=float(payload.get("top_p", 1.0)),
            min_p=float(payload.get("min_p", 0.0)),
            repetition_penalty=float(
                payload.get("repetition_penalty", 1.0)),
            presence_penalty=float(payload.get("presence_penalty", 0.0)),
            frequency_penalty=float(payload.get("frequency_penalty", 0.0)),
            logprobs=int(payload.get("logprobs", 0)),
            stop=tuple(tuple(s) for s in stop))
        max_new = int(payload.get("max_new", 16))
        min_new = int(payload.get("min_new", 0))
        eos_id = payload.get("eos_id")
        eos_id = None if eos_id is None else int(eos_id)
    except (TypeError, ValueError) as e:
        raise _BadRequest(f"bad sampling field: {e}") from e
    if max_new < 1:
        raise _BadRequest('"max_new" must be >= 1')
    if min_new < 0:
        raise _BadRequest('"min_new" must be >= 0')
    return Request(np.asarray(prompt, np.int32), max_new=max_new,
                   sampling=sp, eos_id=eos_id, min_new=min_new)


class FrontendServer:
    """The HTTP front door around an :class:`AsyncEngineDriver` or a
    :class:`~repro_torch.serving.router.ReplicaRouter` (both expose the same
    ``submit`` / ``abort`` / ``draining`` / ``queue_depth`` surface)."""

    def __init__(self, driver, *,
                 host: str = "127.0.0.1", port: int = 0):
        self.driver = driver
        self.host = host
        self.port = port                      # 0 = ephemeral; set by start
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def aclose(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- connection handling ------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, _headers, body = await _read_request(reader)
            except (_BadRequest, asyncio.IncompleteReadError,
                    UnicodeDecodeError) as e:
                await self._json(writer, 400, "Bad Request",
                                 {"error": str(e)})
                return
            if (method, path) == ("POST", "/generate"):
                await self._generate(writer, body)
            elif (method, path) == ("GET", "/health"):
                await self._health(writer)
            elif (method, path) == ("GET", "/metrics"):
                await self._metrics(writer)
            else:
                await self._json(writer, 404, "Not Found",
                                 {"error": f"no route {method} {path}"})
        except (ConnectionResetError, BrokenPipeError):
            pass                          # client went away mid-response
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _json(self, writer, status: int, reason: str, payload: dict,
                    extra=()) -> None:
        body = (json.dumps(payload) + "\n").encode()
        writer.write(_response_head(status, reason, "application/json",
                                    len(body), extra))
        writer.write(body)
        await writer.drain()

    # -- routes -------------------------------------------------------------

    async def _health(self, writer) -> None:
        # the driver is either an AsyncEngineDriver (one engine) or a
        # ReplicaRouter (a fleet: aggregate across `.engines`)
        engines = (self.driver.engines if hasattr(self.driver, "engines")
                   else [self.driver.engine])
        draining = self.driver.draining
        payload = {"status": "draining" if draining else "ok",
                   "model": engines[0].cfg.name,
                   "replicas": len(engines),
                   "running": sum(len(e.sched.running) for e in engines),
                   "queued": self.driver.queue_depth,
                   "steps": sum(e.stats["steps"] for e in engines),
                   "requests_done": sum(e.stats["requests_done"]
                                        for e in engines)}
        if draining:
            await self._json(writer, 503, "Service Unavailable", payload)
        else:
            await self._json(writer, 200, "OK", payload)

    async def _metrics(self, writer) -> None:
        body = metrics_mod.render_metrics_for(self.driver).encode()
        writer.write(_response_head(200, "OK", metrics_mod.CONTENT_TYPE,
                                    len(body)))
        writer.write(body)
        await writer.drain()

    async def _generate(self, writer, body: bytes) -> None:
        try:
            req = _parse_generate(body)
        except _BadRequest as e:
            await self._json(writer, 400, "Bad Request", {"error": str(e)})
            return
        try:
            stream = await self.driver.submit(req)
        except ShedError as e:
            status, reason = ((503, "Service Unavailable")
                              if e.reason == "draining"
                              else (429, "Too Many Requests"))
            await self._json(
                writer, status, reason,
                {"error": str(e), "reason": e.reason,
                 "retry_after_s": e.retry_after_s,
                 "projected_ttft_s": e.projected_ttft_s},
                extra=(("Retry-After",
                        str(max(1, math.ceil(e.retry_after_s)))),))
            return
        except ValueError as e:               # scheduler validation
            await self._json(writer, 400, "Bad Request", {"error": str(e)})
            return
        writer.write(_response_head(
            200, "OK", "text/event-stream",
            None, extra=(("Cache-Control", "no-store"),)))
        await writer.drain()
        n = 0
        try:
            async for ev in stream:
                n += 1
                event = {"index": ev.index, "token": ev.token,
                         "text": ev.text}
                if ev.logprobs is not None:
                    event["logprobs"] = ev.logprobs
                payload = json.dumps(event)
                writer.write(f"data: {payload}\n\n".encode())
                await writer.drain()          # stream, don't batch
            writer.write(
                ("data: " + json.dumps({"done": True, "rid": req.rid,
                                        "n_tokens": n}) + "\n\n"
                 + "data: [DONE]\n\n").encode())
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            # client went away mid-stream: cancel the request — its slot,
            # blocks and host-swap pages free up between steps instead of
            # computing tokens nobody will read
            self.driver.dropped_streams += 1
            self.driver.abort(req.rid)
            raise
