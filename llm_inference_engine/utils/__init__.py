from llm_inference_engine.utils.checks import assert_finite, nan_guard
from llm_inference_engine.utils.common import cdiv, cpu_devices, round_up

__all__ = [
    "assert_finite",
    "nan_guard",
    "cdiv",
    "round_up",
    "cpu_devices",
]
