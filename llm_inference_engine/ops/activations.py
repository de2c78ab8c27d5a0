"""SwiGLU activation and residual add.

Capability parity with:
- ``launchSiluAndMul`` (reference: src/kernels/silu_and_mul.cu:61-82):
  ``silu(gate) * up`` over the packed gate/up projection output. The
  reference stores gate and up as two slices of one [bs, 2, inter] buffer
  (silu_and_mul.cu:36-40) because its GEMM is fused
  (src/layers/ffn.cpp:105); we keep the same packed [tokens, 2*inter]
  convention with gate = [:, :inter], up = [:, inter:].
- ``launchAddResidual`` (reference: src/kernels/add_residual.cu:51-76):
  plain elementwise residual add after the FFN down-projection.

Both are plain XLA: the slice + silu + mul (and the add) fuse into the
neighbouring ops' single pass over memory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["silu_and_mul", "add_residual"]


def silu_and_mul(gate_up: jax.Array) -> jax.Array:
    """gate_up: [..., 2*inter] packed (gate then up) -> [..., inter]."""
    inter = gate_up.shape[-1] // 2
    gate = gate_up[..., :inter].astype(jnp.float32)
    up = gate_up[..., inter:].astype(jnp.float32)
    return (jax.nn.silu(gate) * up).astype(gate_up.dtype)


def add_residual(x: jax.Array, residual: jax.Array) -> jax.Array:
    return (x.astype(jnp.float32) + residual.astype(jnp.float32)).astype(x.dtype)
