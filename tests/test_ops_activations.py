"""Unit tests: SwiGLU (silu_and_mul) + residual add.

Mirrors reference tests/unit_tests/test_silu_and_mul.cu (CPU golden,
test_silu_and_mul.cu:16) and test_add_residual.cu:10.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from llm_inference_engine.ops.activations import add_residual, silu_and_mul


def np_silu_mul(gate_up):
    inter = gate_up.shape[-1] // 2
    g = gate_up[..., :inter].astype(np.float64)
    u = gate_up[..., inter:].astype(np.float64)
    return (g / (1 + np.exp(-g))) * u


@pytest.mark.parametrize("shape", [(16, 512), (7, 256), (2, 5, 256)])
def test_silu_and_mul_matches_numpy(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    got = np.asarray(silu_and_mul(jnp.asarray(x)))
    np.testing.assert_allclose(got, np_silu_mul(x), atol=1e-4, rtol=1e-4)


def test_add_residual(rng):
    x = rng.normal(size=(8, 128)).astype(np.float32)
    r = rng.normal(size=(8, 128)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(add_residual(jnp.asarray(x), jnp.asarray(r))), x + r,
        atol=1e-6)


def test_silu_and_mul_bf16_matches_numpy(rng):
    """bf16 storage: the f32 result rounded once to bf16."""
    x = jnp.asarray(rng.normal(size=(8, 2 * 11008)), jnp.bfloat16)
    got = np.asarray(silu_and_mul(x), np.float32)
    want = np_silu_mul(np.asarray(x, np.float32))
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=2 ** -7)
