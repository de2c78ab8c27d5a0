"""Unit tests: rmsnorm + fused add-residual+rmsnorm.

Mirrors reference tests/unit_tests/test_rmsnorm.cu (CPU golden at 1e-3,
test_rmsnorm.cu:10-40) and test_add_residual_and_rmsnorm.cu — upgraded to
asserts against a NumPy golden.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from llm_inference_engine.ops.rmsnorm import add_residual_rmsnorm, rmsnorm


def np_rmsnorm(x, w, eps):
    var = np.mean(x.astype(np.float64) ** 2, axis=-1, keepdims=True)
    return (x / np.sqrt(var + eps)) * w


@pytest.mark.parametrize("shape", [(64, 256), (13, 512), (3, 7, 128)])
@pytest.mark.parametrize("dtype", [np.float32])
def test_rmsnorm_matches_numpy(rng, shape, dtype):
    x = rng.normal(size=shape).astype(dtype)
    w = rng.normal(size=shape[-1:]).astype(dtype)
    eps = 1e-5
    got = np.asarray(rmsnorm(jnp.asarray(x), jnp.asarray(w), eps))
    want = np_rmsnorm(x, w, eps)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_add_residual_rmsnorm(rng):
    x = rng.normal(size=(33, 256)).astype(np.float32)
    r = rng.normal(size=(33, 256)).astype(np.float32)
    w = rng.normal(size=(256,)).astype(np.float32)
    y, h = add_residual_rmsnorm(jnp.asarray(x), jnp.asarray(r),
                                jnp.asarray(w), 1e-5)
    # the fused op must return the pre-norm sum as the new residual
    # (reference add_residual_and_rmsnorm.cu:71-83 semantics)
    np.testing.assert_allclose(np.asarray(h), x + r, atol=1e-5)
    np.testing.assert_allclose(np.asarray(y), np_rmsnorm(x + r, w, 1e-5),
                               atol=1e-3, rtol=1e-3)


def test_rmsnorm_bf16_accumulates_in_f32(rng):
    """bf16 storage, f32 accumulation: the result is the f32 norm rounded
    once to bf16 (at 7B width, where a bf16 running sum would drift)."""
    x = rng.normal(size=(8, 4096)).astype(np.float32)
    w = rng.normal(size=(4096,)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = np.asarray(rmsnorm(xb, jnp.asarray(w, jnp.bfloat16)),
                     np.float32)
    want = np_rmsnorm(np.asarray(xb, np.float32),
                      np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32),
                      1e-5)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2 ** -7)
