"""RMSNorm and fused add-residual + RMSNorm.

Capability parity with the reference's two norm kernels:
- ``launchRMSNorm`` (reference: src/kernels/rmsnorm.cu:130-159) — normalizes
  the hidden states and *keeps the pre-norm value* for the residual path
  (rmsnorm.cu:55 copies input to the residual buffer). Functionally: the
  caller here simply keeps its input array — no copy kernel needed.
- ``launchFusedAddBiasResidualAndRMSNorm``
  (reference: src/kernels/add_residual_and_rmsnorm.cu:170-201) — fused
  ``h = x + residual; y = rmsnorm(h) ; residual' = h`` in one pass over HBM.

Plain XLA: an elementwise chain plus one row reduction, which XLA fuses into
a single read and write per row on the GPU. Accumulation is always f32
regardless of storage dtype (the reference similarly accumulated in float,
rmsnorm.cu:17-24).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["rmsnorm", "add_residual_rmsnorm"]


def rmsnorm(x: jax.Array, weight: jax.Array, eps: float = 1e-5) -> jax.Array:
    """y = x / rms(x) * weight over the last axis, accumulating in f32.
    Accepts any leading batch dims."""
    xf = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    y = xf * jax.lax.rsqrt(var + eps)
    return (y * weight.astype(jnp.float32)).astype(x.dtype)


def add_residual_rmsnorm(x: jax.Array, residual: jax.Array,
                         weight: jax.Array, eps: float = 1e-5):
    """Fused residual add + RMSNorm: h = x + residual; returns
    (rmsnorm(h), h)."""
    h = (x.astype(jnp.float32) + residual.astype(jnp.float32)).astype(x.dtype)
    return rmsnorm(h, weight, eps), h
