"""SwiGLU FFN driver (reference: examples/cpp/ffn_example, chain
ffn.cpp:105-132 — packed gate|up GEMM -> SwiGLU -> down GEMM)."""

import sys, os
sys.path.insert(0, os.path.dirname(__file__))
import _common  # noqa: F401
from _common import report

import jax
import jax.numpy as jnp

from llm_inference_engine.ops.activations import silu_and_mul
from llm_inference_engine.ops.linear import linear

T, Hd, I = 24, 128, 256
key = jax.random.PRNGKey(2)
kx, kg, kd = jax.random.split(key, 3)
x = jax.random.normal(kx, (1, T, Hd), jnp.float32) * 0.5
w_gate_up = jax.random.normal(kg, (Hd, 2, I), jnp.float32) * 0.05
w_down = jax.random.normal(kd, (I, Hd), jnp.float32) * 0.05

gate_up = linear(x, w_gate_up)            # [1, T, 2, I]
act = silu_and_mul(gate_up)               # [1, T, I]
y = linear(act, w_down)                   # [1, T, Hd]

# golden
g = jnp.einsum("bth,hi->bti", x, w_gate_up[:, 0])
u = jnp.einsum("bth,hi->bti", x, w_gate_up[:, 1])
want = jnp.einsum("bti,ih->bth", jax.nn.silu(g) * u, w_down)
err = float(jnp.max(jnp.abs(y - want)))
report("SwiGLU FFN block", err < 1e-4, f"max err {err:.2e}")
