"""Unit tests: decode (Sq == 1) attention over the KV cache
(ops/attention.py) against the float32 reference, across MHA/GQA, plain
and layered caches with a ``kv_hi`` bound, separate-scale int8 and
embedded-scale int8 caches, and the write-then-attend sequence the model
runs. The tolerance is bf16-dot level: production dots take the storage
dtype's operands, while the reference computes in f32 at "highest"
precision.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from llm_inference_engine.ops.attention import attention, attention_ref
from llm_inference_engine.ops.kv_cache import quantize_kv_embedded

TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("K,G", [(8, 1), (8, 4), (16, 2)])
def test_decode_matches_reference(rng, K, G):
    B, D, S = 2, 128, 48
    H = K * G
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v = rng.normal(size=(B, S, K, D)).astype(np.float32)
    qs = np.array([5, S - 1], np.int32)
    kl = qs + 1

    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(qs), jnp.asarray(kl))
    want = np.asarray(attention_ref(*args))
    got = np.asarray(attention(*args))
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_layered_with_watermark(rng):
    L, B, K, G, D, S = 3, 2, 8, 2, 128, 64
    H = K * G
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    v = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    qs = np.array([3, 30], np.int32)
    kl = qs + 1
    ly = jnp.asarray(2, jnp.int32)

    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(qs), jnp.asarray(kl))
    want = np.asarray(attention_ref(*args, layer=ly))
    got = np.asarray(attention(*args, layer=ly, kv_hi=32))
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_separate_scale_int8(rng):
    B, K, G, D, S = 2, 8, 2, 128, 32
    H = K * G
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kq = rng.integers(-127, 128, size=(B, S, K, D)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(B, S, K, D)).astype(np.int8)
    ks = (rng.random((B, S, K)).astype(np.float32) * 0.02 + 0.001)
    vs = (rng.random((B, S, K)).astype(np.float32) * 0.02 + 0.001)
    qs = np.array([10, 31], np.int32)
    kl = qs + 1

    args = (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(qs), jnp.asarray(kl))
    kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = np.asarray(attention_ref(*args, **kw))
    got = np.asarray(attention(*args, **kw))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_decode_embedded_int8(rng, G):
    B, K, D, S = 2, 8, 128, 32
    H = K * G
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kf = rng.normal(size=(B, S, K, D)).astype(np.float32)
    vf = rng.normal(size=(B, S, K, D)).astype(np.float32)
    pk = quantize_kv_embedded(jnp.asarray(kf))
    pv = quantize_kv_embedded(jnp.asarray(vf))
    qs = np.array([4, 20], np.int32)
    kl = qs + 1

    args = (jnp.asarray(q), pk, pv, jnp.asarray(qs), jnp.asarray(kl))
    want = np.asarray(attention_ref(*args, embedded_kv=True))
    got = np.asarray(attention(*args, embedded_kv=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_write_then_attend(rng):
    """The model's decode sequence: the new token's K/V land in the
    stacked cache (written layer only, at position hist), then attention
    over the updated cache matches the reference."""
    from llm_inference_engine.ops import kv_cache as kvc

    L, B, K, G, D, S = 2, 2, 8, 2, 128, 32
    H = K * G
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kc = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    vc = rng.normal(size=(L, B, S, K, D)).astype(np.float32)
    kn = rng.normal(size=(B, 1, K, D)).astype(np.float32)
    vn = rng.normal(size=(B, 1, K, D)).astype(np.float32)
    hist = np.array([6, 17], np.int32)
    kv_len = hist + 1
    ly = jnp.asarray(1, jnp.int32)

    cache = kvc.KVCache(jnp.asarray(kc), jnp.asarray(vc),
                        jnp.asarray(hist))
    cache = kvc.update_cache_at_layer(cache, ly, jnp.asarray(kn),
                                      jnp.asarray(vn), jnp.asarray(hist))
    out = attention(jnp.asarray(q), cache.k, cache.v, jnp.asarray(hist),
                    jnp.asarray(kv_len), layer=ly, kv_hi=32)

    # cache must contain the new token at position hist (written layer only)
    k2 = np.asarray(cache.k)
    for b in range(B):
        np.testing.assert_allclose(k2[1, b, hist[b]], kn[b, 0], atol=1e-6)
    np.testing.assert_allclose(k2[0], kc[0], atol=0)       # other layer untouched

    want = np.asarray(attention_ref(
        jnp.asarray(q), cache.k, cache.v,
        jnp.asarray(hist), jnp.asarray(kv_len), layer=ly))
    np.testing.assert_allclose(np.asarray(out), want, **TOL)
