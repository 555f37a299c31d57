from .engine import GenerationResult, InferenceEngine
from .prompt_lookup import PromptLookupEngine
from .speculative import SpecStats, SpeculativeEngine

__all__ = ["InferenceEngine", "GenerationResult", "SpeculativeEngine",
           "SpecStats", "PromptLookupEngine"]
