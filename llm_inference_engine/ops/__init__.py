"""Compute ops of the decoder, one module per capability of the
reference's kernel tier (reference: src/kernels/*.cu — 17 CUDA kernels +
cuBLAS wrappers). Each op is plain JAX that XLA compiles for the card;
ops whose numerics differ from float32 (attention, the quantized matmul)
also expose a float32 ``<op>_ref`` at "highest" matmul precision, used
only by tests and chip checks.

CUDA machinery that exists only because of GPU scheduling — padding-offset
bookkeeping (cal_padding_offset.cu), repeat-KV densification (repeat_kv.cu),
transpose-and-remove-padding (transpose_and_remove_padding.cu), materialized
causal masks (build_causal_mask.cu) — has no counterpart here by
design: the attention op handles GQA, causality, and ragged lengths
natively over a dense static-shape batch.
"""

# Submodules are the public surface (functions keep their module namespaces
# so that e.g. ``ops.rmsnorm`` the module and its main entry point never
# shadow each other).
from llm_inference_engine.ops import (  # noqa: F401
    activations,
    attention,
    embedding,
    kv_cache,
    linear,
    quant,
    rmsnorm,
    rope,
    sampling,
)

__all__ = [
    "activations",
    "attention",
    "embedding",
    "kv_cache",
    "linear",
    "quant",
    "rmsnorm",
    "rope",
    "sampling",
]
