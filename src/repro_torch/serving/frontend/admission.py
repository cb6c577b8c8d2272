"""SLO-aware admission control for the streaming front-end (a copy of
``repro.serving.frontend.admission``, which the port may not import:
``import repro`` pulls in jax).

The controller answers one question per arriving request: *if we queue
this now, will its time-to-first-token blow the SLO?* — and sheds (HTTP
429 with a retry signal) instead of letting the queue build unbounded
latency. Estimation is deliberately simple and fully observable:

* a rolling window of realized TTFT samples (seconds from ``submit`` to
  the first streamed token, fed by the driver) gives the *current* p95;
* the rolling mean interval between admissions (waiting -> running
  transitions, fed from the scheduler's ``on_admit`` hook) gives the
  queue drain rate;
* a new request behind ``queue_depth`` others projects to

      projected_ttft_p95 = p95(ttft window)
                           + queue_depth * admit_interval / n_replicas

  — every queued request ahead delays the newcomer's prefill start by
  roughly one admission interval, divided by the number of data-parallel
  replicas draining the shared queue. When ``projected > ttft_slo_p95_s``
  the request is shed with ``retry_after_s ~= projected - target``.

A bounded queue (``max_queue``) backstops the estimator: past that depth
requests are shed regardless of the SLO projection (cold-start windows
are empty, and an estimator must never be the only thing between the
server and an unbounded queue).

Unit-agnostic and dependency-free: samples and targets just have to share
a unit (the driver feeds wall seconds; tests may feed engine steps).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

__all__ = ["AdmissionController", "AdmissionDecision"]

# shed responses always carry a positive retry hint, even before the
# admit-interval window has samples to derive one from
MIN_RETRY_AFTER_S = 0.05


@dataclass(frozen=True)
class AdmissionDecision:
    admit: bool
    reason: str = ""                 # "", "queue_full", "ttft_slo"
    retry_after_s: float = 0.0       # > 0 on every shed decision
    projected_ttft_s: float = 0.0


class AdmissionController:
    """Shed-or-admit policy over live TTFT stats and queue depth.

    ``ttft_slo_p95_s=None`` disables the SLO projection (the bounded
    queue still applies), which is how the synthetic Poisson bench keeps
    its rows comparable with the direct ``engine.run`` path — same
    admission code, nothing shed.
    """

    def __init__(self, *, ttft_slo_p95_s: float | None = None,
                 max_queue: int = 128, window: int = 256,
                 n_replicas: int = 1):
        if max_queue < 0:
            raise ValueError(f"max_queue={max_queue} must be >= 0")
        if n_replicas < 1:
            raise ValueError(f"n_replicas={n_replicas} must be >= 1")
        self.ttft_slo_p95_s = ttft_slo_p95_s
        self.max_queue = max_queue
        # queue-drain parallelism: N data-parallel replicas consume the
        # shared queue N-at-a-time, so a queued newcomer waits only
        # depth/N admit intervals — without this, dp>1 projects the dp=1
        # drain rate and spuriously sheds load the fleet can absorb
        self.n_replicas = n_replicas
        self._ttft = deque(maxlen=window)
        self._admit_marks = deque(maxlen=window)
        # counters the /metrics endpoint exports
        self.submitted = 0          # accepted into the front-end queue
        self.shed = 0
        self.completed = 0
        self.queue_peak = 0

    # -- observations (driver-fed) ----------------------------------------

    def note_ttft(self, seconds: float) -> None:
        self._ttft.append(float(seconds))

    def note_admit(self, t: float) -> None:
        """One waiting -> running transition at monotonic time ``t``."""
        self._admit_marks.append(float(t))

    def note_submitted(self, queue_depth: int) -> None:
        self.submitted += 1
        self.queue_peak = max(self.queue_peak, queue_depth + 1)

    def note_completed(self) -> None:
        self.completed += 1

    # -- estimation --------------------------------------------------------

    def ttft_p95(self) -> float:
        if not self._ttft:
            return 0.0
        xs = sorted(self._ttft)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]

    def mean_admit_interval(self) -> float:
        m = self._admit_marks
        if len(m) < 2:
            return 0.0
        return (m[-1] - m[0]) / (len(m) - 1)

    def projected_ttft_p95(self, queue_depth: int) -> float:
        return self.ttft_p95() \
            + queue_depth * self.mean_admit_interval() / self.n_replicas

    # -- the decision ------------------------------------------------------

    def decide(self, queue_depth: int) -> AdmissionDecision:
        """Pure read (no counter mutation): the driver records the
        outcome via ``note_submitted`` / ``note_shed``."""
        projected = self.projected_ttft_p95(queue_depth)
        if queue_depth >= self.max_queue:
            retry = max(self.mean_admit_interval() * queue_depth,
                        MIN_RETRY_AFTER_S)
            return AdmissionDecision(False, "queue_full", retry, projected)
        if (self.ttft_slo_p95_s is not None and self._ttft
                and projected > self.ttft_slo_p95_s):
            retry = max(projected - self.ttft_slo_p95_s, MIN_RETRY_AFTER_S)
            return AdmissionDecision(False, "ttft_slo", retry, projected)
        return AdmissionDecision(True, projected_ttft_s=projected)

    def note_shed(self) -> None:
        self.shed += 1
