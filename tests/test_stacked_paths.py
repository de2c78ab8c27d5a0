"""Stacked-layer paths: the quantized matmul indexing whole [L, ...]
weights and attention indexing the stacked [L, B, S, K, D] cache by a
traced layer id must equal the per-layer computation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from llm_inference_engine.ops.attention import attention, attention_ref
from llm_inference_engine.ops.quant import (
    QuantizedTensor, quantize_tensor, quantized_linear)


def _stack_quant(ws, mode, group_size, structured=False):
    """ws: list of [in, out] -> stacked QuantizedTensor
    ([L, in', out] or gate|up [L, 2, in', I])."""
    qs, ss = [], []
    for w in ws:
        t = quantize_tensor(jnp.asarray(w), mode, group_size)
        q, s = t.q, t.scale
        if structured:
            q = q.reshape(q.shape[0], 2, -1).transpose(1, 0, 2)
            s = s.reshape(s.shape[0], 2, -1).transpose(1, 0, 2)
        qs.append(q)
        ss.append(s)
    return QuantizedTensor(q=jnp.stack(qs), scale=jnp.stack(ss), mode=mode,
                           group_size=group_size)


@pytest.mark.parametrize("mode,group", [("int8", 128), ("int4", 128)])
def test_stacked_quantized_linear_matches_per_layer(rng, mode, group):
    L, m, k, n = 3, 16, 256, 512
    ws = [rng.normal(size=(k, n)).astype(np.float32) * 0.1 for _ in range(L)]
    x = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32))
    stacked = _stack_quant(ws, mode, group)
    for l in range(L):
        t = quantize_tensor(jnp.asarray(ws[l]), mode, group)
        want = quantized_linear(x, t)
        got = quantized_linear(x, stacked,
                               layer=jnp.int32(l))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_stacked_structured_gate_up(rng, mode):
    L, m, k, I = 2, 8, 256, 256
    ws = [rng.normal(size=(k, 2 * I)).astype(np.float32) * 0.1
          for _ in range(L)]
    x = jnp.asarray(rng.normal(size=(m, k)).astype(np.float32))
    stacked = _stack_quant(ws, mode, 128, structured=True)
    assert stacked.q.ndim == 4 and stacked.q.shape[1] == 2
    for l in range(L):
        t = quantize_tensor(jnp.asarray(ws[l]), mode, 128)
        want = quantized_linear(x, t)     # [m, 2I] packed
        got = quantized_linear(x, stacked,
                               layer=jnp.int32(l))
        assert got.shape == (m, 2 * I)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-3, rtol=1e-3)


def test_stacked_attention_matches_per_layer(rng):
    L, B, S, K, G, D = 3, 2, 64, 2, 2, 32
    H = K * G
    kc = jnp.asarray(rng.normal(size=(L, B, S, K, D)).astype(np.float32))
    vc = jnp.asarray(rng.normal(size=(L, B, S, K, D)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(B, 1, H, D)).astype(np.float32))
    qs = jnp.asarray(np.array([10, 63], np.int32))
    kl = qs + 1
    for l in range(L):
        got = attention(q, kc, vc, qs, kl,
                        layer=jnp.int32(l))
        want = attention(q, kc[l], vc[l], qs, kl)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        golden = attention_ref(q, kc, vc, qs, kl, layer=jnp.int32(l))
        np.testing.assert_allclose(np.asarray(got), np.asarray(golden),
                                   atol=2e-4, rtol=2e-4)


def test_stacked_attention_int8_kv(rng):
    L, B, S, K, D = 2, 2, 32, 2, 32
    H = K
    kc = rng.integers(-127, 128, size=(L, B, S, K, D)).astype(np.int8)
    vc = rng.integers(-127, 128, size=(L, B, S, K, D)).astype(np.int8)
    sc = (np.abs(rng.normal(size=(L, B, S, K))) * 0.01 + 1e-3).astype(
        np.float32)
    q = jnp.asarray(rng.normal(size=(B, 1, H, D)).astype(np.float32))
    qs = jnp.asarray(np.array([5, 31], np.int32))
    kl = qs + 1
    got = attention(q, jnp.asarray(kc), jnp.asarray(vc), qs, kl, layer=jnp.int32(1),
                    k_scale=jnp.asarray(sc), v_scale=jnp.asarray(sc))
    want = attention_ref(q, jnp.asarray(kc), jnp.asarray(vc), qs, kl,
                         layer=jnp.int32(1), k_scale=jnp.asarray(sc),
                         v_scale=jnp.asarray(sc))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-4, rtol=2e-4)


def test_attention_kv_hi_watermark(rng):
    """kv_hi must not change results as long as it covers every kv_len."""
    B, S, K, D = 2, 64, 2, 32
    kc = jnp.asarray(rng.normal(size=(B, S, K, D)).astype(np.float32))
    vc = jnp.asarray(rng.normal(size=(B, S, K, D)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(B, 1, K, D)).astype(np.float32))
    qs = jnp.asarray(np.array([7, 30], np.int32))
    kl = qs + 1
    full = attention(q, kc, vc, qs, kl)
    marked = attention(q, kc, vc, qs, kl,
                       kv_hi=32)
    np.testing.assert_allclose(np.asarray(marked), np.asarray(full),
                               atol=1e-6, rtol=1e-6)
