"""The runtime's public surface: the engines, the elastic pipeline and
the host KV cache manager, as the reference's ``runtime`` package
exports them.  The elastic classes reach ``comm/`` and the batching
engine the telemetry stack, so they (and the manager) import on first
use."""

from .engine import GenerationResult, InferenceEngine
from .prompt_lookup import PromptLookupEngine
from .speculative import SpecStats, SpeculativeEngine

_LAZY = {"ContinuousBatchingEngine": ".batching",
         "ElasticHeader": ".elastic", "ElasticStageRuntime": ".elastic",
         "ElasticWorker": ".elastic", "KVCacheManager": ".kvcache"}

__all__ = ["InferenceEngine", "GenerationResult", "ElasticHeader",
           "ElasticStageRuntime", "ElasticWorker", "SpeculativeEngine",
           "SpecStats", "ContinuousBatchingEngine", "KVCacheManager",
           "PromptLookupEngine"]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
