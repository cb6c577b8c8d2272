"""Serving statistics primitives: Prometheus-style histograms (a copy of
``repro.serving.stats``, which the port may not import).

The engine aggregates per-request TTFT / end-to-end latency into fixed-
bucket :class:`Histogram`\\ s at retirement time, so the rolling
``stats["latency"]`` dict can stay bounded (old per-request records are
evicted) without the metrics surface losing data: a histogram is O(number
of buckets) forever, which is what lets a serve loop run for millions of
requests. ``render`` emits the Prometheus text exposition format.

Dependency-free on purpose (no torch, no numpy).
"""

from __future__ import annotations

from bisect import bisect_left

__all__ = ["Histogram", "SECONDS_BUCKETS", "STEP_BUCKETS"]

# wall-clock latency buckets (seconds): spans interpret-mode CPU smoke
# runs (tens of seconds) down to real-accelerator decode steps (ms)
SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

# virtual-clock buckets (engine steps): deterministic across hosts, the
# unit the scheduler tests and the bench's `steps` percentiles use
STEP_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                512.0, 1024.0)


class Histogram:
    """Fixed-bucket histogram with Prometheus exposition semantics.

    ``uppers`` are inclusive bucket upper bounds (``le``); an implicit
    ``+Inf`` bucket catches the tail. ``render`` emits *cumulative* bucket
    counts plus ``_sum`` / ``_count``, exactly the text format Prometheus
    scrapes. ``percentile`` gives a conservative (bucket-upper-bound)
    estimate for host-side reporting and the admission controller.
    """

    def __init__(self, uppers=SECONDS_BUCKETS):
        self.uppers = tuple(sorted(float(u) for u in uppers))
        if not self.uppers:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.uppers) + 1)     # + the +Inf bucket
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.uppers, float(v))] += 1
        self.count += 1
        self.total += float(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket containing the q-th percentile
        (q in [0, 100]); 0.0 when empty, last finite bound for the +Inf
        bucket. Conservative by construction — never underestimates."""
        if not self.count:
            return 0.0
        need = max(1, -(-int(q * self.count) // 100))   # ceil(q% of count)
        seen = 0
        for upper, c in zip(self.uppers, self.counts):
            seen += c
            if seen >= need:
                return upper
        return self.uppers[-1]

    def merge(self, other: "Histogram") -> "Histogram":
        """Add ``other``'s observations into this histogram, in place.
        Bucket bounds must match exactly (fleet aggregation merges
        replicas built from the same constants). Returns self, so
        ``reduce(Histogram.merge, hists, Histogram(b))`` folds a fleet.

        Equivalence contract (pinned by tests): merging N histograms is
        indistinguishable — counts, sum, count, percentiles, rendering —
        from one histogram that observed the concatenated samples."""
        if other.uppers != self.uppers:
            raise ValueError(
                f"bucket mismatch: {self.uppers} != {other.uppers}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        return self

    def render(self, name: str, help_: str, out: list[str],
               labels: dict | None = None, header: bool = True) -> None:
        """Append Prometheus text-format lines for this histogram.

        ``labels`` adds constant label pairs to every series (e.g.
        ``{"replica": "0"}`` for per-replica fleet series); ``header``
        False suppresses the HELP/TYPE preamble so several labeled
        histograms can share one metric family."""
        if header:
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} histogram")
        base = "".join(f'{k}="{v}",' for k, v in (labels or {}).items())
        tail = ("{" + base.rstrip(",") + "}") if base else ""
        cum = 0
        for upper, c in zip(self.uppers, self.counts):
            cum += c
            out.append(
                f'{name}_bucket{{{base}le="{format(upper, "g")}"}} {cum}')
        out.append(f'{name}_bucket{{{base}le="+Inf"}} {self.count}')
        out.append(f"{name}_sum{tail} {format(self.total, 'g')}")
        out.append(f"{name}_count{tail} {self.count}")
