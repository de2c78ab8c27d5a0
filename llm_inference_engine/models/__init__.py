from llm_inference_engine.models import llama, weights  # noqa: F401

__all__ = ["llama", "weights"]
