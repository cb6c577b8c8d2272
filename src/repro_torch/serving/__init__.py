"""Continuous-batching serving: block manager, scheduler, runners, engine,
and the data-parallel router. The request-facing async streaming front
end (driver, SLO admission control, HTTP/SSE, /metrics) lives in
``repro_torch.serving.frontend``."""

from repro_torch.serving.cache import EncoderCache, SlotStateCache
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.kv_cache import (BlockManager, SharedPrefixIndex,
                                          init_paged_cache)
from repro_torch.serving.router import ReplicaRouter, RouterStream
from repro_torch.serving.runners import (EncDecRunner, HybridRunner,
                                         ModelRunner, SpeculativeRunner,
                                         SSMRunner, TransformerRunner,
                                         make_runner)
from repro_torch.serving.scheduler import Request, SamplingParams, Scheduler

__all__ = ["InferenceEngine", "BlockManager", "SharedPrefixIndex",
           "ReplicaRouter", "RouterStream", "SlotStateCache",
           "EncoderCache", "init_paged_cache", "ModelRunner",
           "TransformerRunner", "SSMRunner", "HybridRunner", "EncDecRunner",
           "SpeculativeRunner", "make_runner",
           "Request", "SamplingParams", "Scheduler"]
