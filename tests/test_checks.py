"""nan_guard / assert_finite (utils/checks.py) — the sanitizer tier."""

import jax
import jax.numpy as jnp
import pytest

from llm_inference_engine.utils.checks import assert_finite, nan_guard


def test_nan_guard_passes_clean_fn():
    def f(x):
        return jnp.sum(x * 2.0)

    g = nan_guard(f)
    out = g(jnp.ones((4, 4), jnp.float32))
    assert float(out) == 32.0


def test_nan_guard_catches_nan():
    def f(x):
        return jnp.sum(jnp.log(x))  # log(-1) -> nan

    g = nan_guard(f)
    with pytest.raises(Exception) as ei:
        g(-jnp.ones((4,), jnp.float32))
    assert "nan" in str(ei.value).lower()


def test_nan_guard_under_jit():
    @jax.jit
    def f(x):
        return x / jnp.sum(x)

    g = nan_guard(f)
    with pytest.raises(Exception):
        g(jnp.zeros((4,), jnp.float32))  # 0/0


def test_assert_finite_silent_and_jittable(capfd):
    @jax.jit
    def f(x):
        assert_finite("x", x)
        return x + 1

    f(jnp.ones((8,), jnp.float32)).block_until_ready()
    jax.effects_barrier()
    assert "non-finite" not in capfd.readouterr().out

    f(jnp.full((8,), jnp.nan, jnp.float32)).block_until_ready()
    jax.effects_barrier()
    assert "non-finite" in capfd.readouterr().out
