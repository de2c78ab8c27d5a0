from llm_inference_engine.runtime.engine import InferenceEngine, GenerationResult
from llm_inference_engine.runtime.prefix_cache import (
    PagedPrefixEntry, PagedPrefixStore, PrefixEntry, PrefixStore)

__all__ = ["InferenceEngine", "GenerationResult", "PrefixEntry",
           "PrefixStore", "PagedPrefixEntry", "PagedPrefixStore"]
