"""LLM inference engine in JAX, for NVIDIA GPUs.

A from-scratch JAX/XLA reimplementation of the capabilities of the CUDA
reference engine ``chongchen1999/llm-inference-engine`` (see SURVEY.md): a
Llama2-class decoder pipeline built from unit-tested fused kernels, with a
prefill/decode split over a persistent KV cache, weight-only INT8/INT4
quantization, GSPMD/shard_map tensor parallelism over a device mesh, continuous
batching, and a streaming chat CLI.

Nothing here is a port: where the reference hand-schedules CUDA blocks, this
package expresses the same capability as XLA fusion (and a Pallas kernel
where one measured faster on the card) over
static shapes (reference: src/kernels/*.cu -> ops/; src/layers/*.cpp ->
models/llama.py; src/models/llama/llama.cpp -> runtime/engine.py).
"""

__version__ = "0.1.0"

from llm_inference_engine.config import ModelConfig, EngineConfig, SamplingParams

__all__ = [
    "ModelConfig",
    "EngineConfig",
    "SamplingParams",
]
