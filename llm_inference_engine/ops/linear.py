"""Dense (and, via ops.quant, dequantizing) matrix multiplication.

Capability parity with ``launchLinearGemm`` / ``launchLinearStridedBatchGemm``
(reference: src/kernels/linear.cu:10-158, thin wrappers over cuBLAS
``cublasGemmEx`` with a column-major transpose trick). Here the GEMM is
``jax.lax.dot_general``: XLA picks cuBLAS or its own generated GEMM and
fuses elementwise epilogues. The batched q@K^T / P@V GEMMs of the reference
live inside the attention op (ops/attention.py) instead of being exposed.

Weights are stored [in, out] (canonicalized at load; the reference instead
carried an ``is_transposed`` flag into every GEMM call,
src/weights/includes/base_weights.h:31, context_attention.cpp:164).

Quantized weights (QuantizedTensor) dispatch to ops/quant.py — the
capability the reference declared but never built (README.md:36-39,
base_weights.h:10 INT8_W).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from llm_inference_engine.ops import quant

__all__ = ["linear"]


def _dense(x: jax.Array, w: jax.Array, bias: jax.Array | None,
           out_dtype: Any) -> jax.Array:
    """y = x @ w (+ bias). x: [..., in], w: [in, out] or [in, *out_dims]
    (trailing out dims are flattened — e.g. the [in, 2, I] gate|up stack).
    Operands stay in their storage dtype; the product accumulates in f32."""
    if w.ndim > 2:
        w = w.reshape(w.shape[0], -1)
    y = jax.lax.dot_general(
        x, w,
        dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(out_dtype)


def linear(x: jax.Array, w, bias=None, out_dtype=None, *,
           layer=None) -> jax.Array:
    """Matmul dispatcher. ``w`` is either a plain [in, out] array or a
    QuantizedTensor (see ops/quant.py). With ``layer`` (traced int32), ``w``
    is a stacked [L, in, ...] weight and layer ``layer`` is used."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, quant.QuantizedTensor):
        return quant.quantized_linear(x, w, bias=bias, out_dtype=out_dtype,
                                      layer=layer)
    if layer is not None:
        w = jax.lax.dynamic_index_in_dim(w, layer, 0, keepdims=False)
    return _dense(x, w, bias, out_dtype)
