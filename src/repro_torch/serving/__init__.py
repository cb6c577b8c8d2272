"""Continuous-batching serving: block manager, scheduler, runner, engine."""

from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import Request, SamplingParams

__all__ = ["InferenceEngine", "Request", "SamplingParams"]
