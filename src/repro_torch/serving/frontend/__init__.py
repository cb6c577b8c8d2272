"""Async streaming front-end around the continuous-batching engine (a copy of
``repro.serving.frontend``, which the port may not import: ``import repro``
pulls in jax).

The request-facing subsystem (docs/serving-frontend.md): an async engine
driver that owns the step loop and streams tokens per request
(``driver.py``), SLO-aware admission control with backpressure
(``admission.py``), a stdlib-only HTTP/SSE surface with live
``/metrics`` + ``/health`` (``http.py``), and Prometheus text rendering
(``metrics.py``).
"""

from repro_torch.serving.frontend.admission import (AdmissionController,
                                              AdmissionDecision)
from repro_torch.serving.frontend.driver import (AsyncEngineDriver, ShedError,
                                           TokenEvent, TokenStream)
from repro_torch.serving.frontend.http import FrontendServer
from repro_torch.serving.frontend.metrics import (render_metrics,
                                            render_metrics_for,
                                            render_router_metrics)

__all__ = ["AsyncEngineDriver", "TokenStream", "TokenEvent", "ShedError",
           "AdmissionController", "AdmissionDecision", "FrontendServer",
           "render_metrics", "render_router_metrics", "render_metrics_for"]
