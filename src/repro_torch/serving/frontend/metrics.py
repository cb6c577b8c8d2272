"""Prometheus text-format rendering of the live serving metrics (a copy of
``repro.serving.frontend.metrics``, which the port may not import: ``import
repro`` pulls in jax).

One function, :func:`render_metrics`, snapshots the engine's counters,
the derived rates (cache-hit rate, preemption rate, mean accept length —
the *same accessors* the bench and serve.py print, so every surface
reports identical numbers), the retirement-time TTFT/e2e histograms, and
— when a driver is attached — the front-end queue/shed/drain state. The
output is the Prometheus text exposition format v0.0.4 (`# HELP` /
`# TYPE` comments, cumulative `_bucket{le=...}` histogram lines), which
is what ``GET /metrics`` serves.

Metric catalog: docs/serving-frontend.md.
"""

from __future__ import annotations

from repro_torch.serving.stats import Histogram

__all__ = ["render_metrics", "render_router_metrics", "render_metrics_for",
           "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# engine.stats key -> (metric name, help text); all monotone counters
_ENGINE_COUNTERS = (
    ("tokens", "repro_engine_tokens_total",
     "Generated tokens appended across all requests"),
    ("steps", "repro_engine_steps_total",
     "Jitted budgeted engine steps executed"),
    ("prefill_chunks", "repro_engine_prefill_chunks_total",
     "Prefill chunks executed"),
    ("prefill_tokens", "repro_engine_prefill_tokens_total",
     "Prompt tokens whose KV was computed (prefix-cache misses)"),
    ("quantum_dropped_tokens", "repro_engine_quantum_dropped_tokens_total",
     "Prefill budget tokens lost to chunk-quantum rounding on a step's "
     "final chunk"),
    ("cache_hit_tokens", "repro_engine_cache_hit_tokens_total",
     "Prompt tokens whose KV was adopted from the prefix cache"),
    ("preemptions", "repro_engine_preemptions_total",
     "Recompute preemptions (victim returned to the waiting queue)"),
    ("cow_copies", "repro_engine_cow_copies_total",
     "Copy-on-write block copies performed"),
    ("encodes", "repro_engine_encodes_total",
     "Admission-time encoder passes (enc-dec runners)"),
    ("requests", "repro_engine_requests_total",
     "Requests that arrived at the engine"),
    ("requests_done", "repro_engine_requests_done_total",
     "Requests retired (EOS or max_new)"),
    ("spec_decodes", "repro_engine_spec_decodes_total",
     "Speculative decode slot-steps (draft-and-verify)"),
    ("spec_emitted", "repro_engine_spec_emitted_total",
     "Tokens emitted by speculative verify steps"),
    ("stop_hits", "repro_engine_stop_hits_total",
     "Requests retired by a per-request stop sequence match"),
    ("full_sampling_steps", "repro_engine_full_sampling_steps_total",
     "Engine steps that ran the full sampling pipeline (top-p/min-p/"
     "penalties/logprobs); pure-greedy steps stay on the plain "
     "executables"),
    ("aborts", "repro_engine_aborts_total",
     "Requests cancelled before retirement (client disconnect / abort)"),
    ("swap_preemptions", "repro_engine_swap_preemptions_total",
     "Preemptions resolved by swapping KV to the host tier instead of "
     "recompute"),
    ("swap_ins", "repro_engine_swap_ins_total",
     "Swapped-out requests re-admitted from the host tier"),
    ("host_hit_blocks", "repro_engine_host_hit_blocks_total",
     "Prefix-cache hits served by copying host-resident blocks back"),
    ("swapped_out_blocks", "repro_engine_swapped_out_blocks_total",
     "KV blocks copied device-to-host by swap preemptions"),
    ("swapped_in_blocks", "repro_engine_swapped_in_blocks_total",
     "KV blocks copied host-to-device by swap-ins and host prefix hits"),
    ("swapped_out_bytes", "repro_engine_swapped_out_bytes_total",
     "Bytes moved device-to-host by swap preemptions"),
    ("swapped_in_bytes", "repro_engine_swapped_in_bytes_total",
     "Bytes moved host-to-device by swap-ins and host prefix hits"),
    ("shared_hit_blocks", "repro_engine_shared_hit_blocks_total",
     "Prefix-cache hits adopted from the cross-replica shared index"),
    ("shared_published_blocks", "repro_engine_shared_published_blocks_total",
     "Hashed KV blocks this replica published into the shared index"),
)

_HISTOGRAMS = (
    ("ttft_seconds", "repro_engine_ttft_seconds",
     "Time to first token, wall seconds (arrival to first sampled token)"),
    ("e2e_seconds", "repro_engine_e2e_seconds",
     "End-to-end request latency, wall seconds (arrival to retirement)"),
    ("ttft_steps", "repro_engine_ttft_steps",
     "Time to first token in engine steps (deterministic virtual clock)"),
    ("e2e_steps", "repro_engine_e2e_steps",
     "End-to-end request latency in engine steps"),
)


def _scalar(out: list[str], name: str, kind: str, help_: str, value):
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} {kind}")
    out.append(f"{name} {format(float(value), 'g')}")


def render_metrics(engine, driver=None) -> str:
    """Render the serving metrics snapshot; ``driver`` (an
    ``AsyncEngineDriver``) adds the front-end queue/admission section."""
    out: list[str] = []
    s = engine.stats
    for key, name, help_ in _ENGINE_COUNTERS:
        _scalar(out, name, "counter", help_, s[key])
    _scalar(out, "repro_engine_cache_hit_rate", "gauge",
            "Fraction of prefill KV served from the prefix cache",
            engine.cache_hit_rate)
    _scalar(out, "repro_engine_preemption_rate", "gauge",
            "Preemptions per arrived request", engine.preemption_rate)
    _scalar(out, "repro_engine_mean_accept_len", "gauge",
            "Mean realized tokens per speculative decode slot-step",
            engine.mean_accept_len)
    _scalar(out, "repro_engine_peak_block_utilization", "gauge",
            "Peak fraction of the KV block pool in use",
            s["peak_block_utilization"])
    _scalar(out, "repro_engine_peak_blocks_in_use", "gauge",
            "Peak KV blocks in use", s["peak_blocks_in_use"])
    _scalar(out, "repro_engine_kv_cache_mib", "gauge",
            "Device cache footprint, MiB", s["kv_cache_mib"])
    _scalar(out, "repro_engine_swap_space_mib", "gauge",
            "Pinned host-swap tier capacity, MiB (0 = swap off)",
            s["swap_space_mib"])
    out.append("# HELP repro_engine_kv_dtype Serving KV-cache storage "
               "dtype, as a one-hot label")
    out.append("# TYPE repro_engine_kv_dtype gauge")
    out.append(f'repro_engine_kv_dtype{{kv_dtype="{s["kv_dtype"]}"}} 1')
    _scalar(out, "repro_engine_running", "gauge",
            "Requests currently occupying a batch slot",
            len(engine.sched.running))
    _scalar(out, "repro_engine_waiting", "gauge",
            "Requests in the scheduler's waiting queue",
            len(engine.sched.waiting))
    for key, name, help_ in _HISTOGRAMS:
        engine.hist[key].render(name, help_, out)
    if driver is not None:
        _render_frontend(out, driver)
    return "\n".join(out) + "\n"


def _render_frontend(out: list[str], driver) -> None:
    """The front-end queue/admission section — shared between the single-
    engine and router renderers (both expose the same driver surface)."""
    adm = driver.admission
    _scalar(out, "repro_frontend_queue_depth", "gauge",
            "Requests admitted by the front-end but not yet running",
            driver.queue_depth)
    _scalar(out, "repro_frontend_queue_peak", "gauge",
            "Peak front-end queue depth", adm.queue_peak)
    _scalar(out, "repro_frontend_requests_submitted_total", "counter",
            "Requests accepted into the front-end queue", adm.submitted)
    _scalar(out, "repro_frontend_requests_shed_total", "counter",
            "Requests shed by admission control (HTTP 429)", adm.shed)
    _scalar(out, "repro_frontend_requests_completed_total", "counter",
            "Front-end requests whose streams closed cleanly",
            adm.completed)
    _scalar(out, "repro_frontend_dropped_streams_total", "counter",
            "SSE streams whose client disconnected mid-stream "
            "(the request is then aborted)",
            driver.dropped_streams)
    _scalar(out, "repro_frontend_aborted_requests_total", "counter",
            "Requests cancelled before retirement via the driver's "
            "abort path", driver.aborted)
    _scalar(out, "repro_frontend_draining", "gauge",
            "1 while draining (no new admissions), else 0",
            1.0 if driver.draining else 0.0)


def render_router_metrics(router) -> str:
    """Render the fleet-wide snapshot for a ``ReplicaRouter``.

    Every engine counter family gets one unlabeled fleet-sum series plus
    per-replica ``{replica="i"}`` series; TTFT/e2e histograms are merged
    with :meth:`Histogram.merge` (merge == histogram of the concatenated
    samples, so fleet percentiles are exact) and also emitted per replica
    under the same family. Router-level series cover routing, the
    disaggregated handoff count, and the shared prefix index.
    """
    out: list[str] = []
    engines = router.engines
    for key, name, help_ in _ENGINE_COUNTERS:
        vals = [e.stats[key] for e in engines]
        _scalar(out, name, "counter", help_, sum(vals))
        for i, v in enumerate(vals):
            out.append(f'{name}{{replica="{i}"}} {format(float(v), "g")}')
    _scalar(out, "repro_engine_running", "gauge",
            "Requests currently occupying a batch slot (fleet total)",
            sum(len(e.sched.running) for e in engines))
    _scalar(out, "repro_engine_waiting", "gauge",
            "Requests in the schedulers' waiting queues (fleet total)",
            sum(len(e.sched.waiting) for e in engines))
    for key, name, help_ in _HISTOGRAMS:
        merged = Histogram(engines[0].hist[key].uppers)
        for e in engines:
            merged.merge(e.hist[key])
        merged.render(name, help_, out)
        for i, e in enumerate(engines):
            e.hist[key].render(name, help_, out,
                               labels={"replica": str(i)}, header=False)
    _scalar(out, "repro_router_replicas", "gauge",
            "Data-parallel engine replicas behind the router", router.dp)
    out.append("# HELP repro_router_routed_total Requests routed to each "
               "replica (least-outstanding-tokens, FCFS tiebreak)")
    out.append("# TYPE repro_router_routed_total counter")
    for i, n in enumerate(router.routed):
        out.append(f'repro_router_routed_total{{replica="{i}"}} '
                   f'{format(float(n), "g")}')
    _scalar(out, "repro_router_handoffs_total", "counter",
            "Disaggregated prefill->decode handoffs (phase-2 "
            "continuations submitted to a decode replica)",
            router.handoffs)
    shared = router.shared_stats()
    if shared:
        _scalar(out, "repro_shared_index_slots", "gauge",
                "Host-pool slots in the shared prefix index",
                shared["slots"])
        _scalar(out, "repro_shared_index_committed", "gauge",
                "Slots currently holding a committed published block",
                shared["committed"])
        _scalar(out, "repro_shared_index_published_total", "counter",
                "Blocks published into the shared index (fleet-wide)",
                shared["published_blocks"])
        _scalar(out, "repro_shared_index_adopted_total", "counter",
                "Block adoptions served by the shared index (fleet-wide)",
                shared["adopted_blocks"])
        _scalar(out, "repro_shared_index_evicted_total", "counter",
                "Committed blocks evicted (LRU) to make room for new "
                "publishes", shared["evicted_blocks"])
    _render_frontend(out, router)
    return "\n".join(out) + "\n"


def render_metrics_for(driver) -> str:
    """Dispatch on the front-end's engine surface: a ``ReplicaRouter``
    (has ``.engines``) renders the fleet view, an ``AsyncEngineDriver``
    the single-engine view."""
    if hasattr(driver, "engines"):
        return render_router_metrics(driver)
    return render_metrics(driver.engine, driver)
