"""Paths that exist only on the card — the int4 kernel as compiled through
Triton and cuDNN prefill attention — against their float32 references.
They skip off the card; on one:

    LLM_ENGINE_TESTS_ON_GPU=1 python -m pytest tests/test_gpu_paths.py -m gpu
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from llm_inference_engine.ops.attention import attention, attention_ref
from llm_inference_engine.ops.quant import (
    int4_matmul_kernel, quantize_tensor, quantized_linear_ref)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("m", [1, 8, 40])
def test_int4_kernel_compiled(gpu, rng, m):
    k, n = 4096, 4096
    t = quantize_tensor(jnp.asarray(rng.normal(size=(k, n)) * 0.02,
                                    jnp.float32), "int4", 128)
    x = jnp.asarray(rng.normal(size=(m, k)), jnp.bfloat16)
    got = np.asarray(jax.jit(int4_matmul_kernel, static_argnums=4)(
        x, t.q[None], t.scale[None], 0, 128))
    want = np.asarray(quantized_linear_ref(x, t, out_dtype=jnp.float32))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-3


@pytest.mark.parametrize("window", [None, 64])
def test_cudnn_prefill_attention(gpu, rng, window):
    B, T, H, K, D, S = 2, 128, 8, 2, 128, 512
    q = jnp.asarray(rng.normal(size=(B, T, H, D)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(B, S, K, D)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(B, S, K, D)), jnp.bfloat16)
    qs = jnp.asarray([0, 200], jnp.int32)
    kl = qs + jnp.asarray([T, 77], jnp.int32)
    got = np.asarray(jax.jit(attention, static_argnames=("kv_hi", "window"))(
        q, k, v, qs, kl, kv_hi=512, window=window), np.float32)
    want = np.asarray(attention_ref(q, k, v, qs, kl, window=window),
                      np.float32)
    for b, n in enumerate((T, 77)):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=2e-2,
                                   rtol=2e-2)
