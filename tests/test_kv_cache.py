"""Unit tests: KV cache update at per-sequence offsets.

Mirrors reference tests/unit_tests/test_concat_past_kv.cu (print-and-inspect
in the reference, test_concat_past_kv.cu:13 — upgraded to asserts).
"""

import numpy as np
import jax.numpy as jnp

from llm_inference_engine.ops.kv_cache import (
    KVCache, new_kv_cache, update_layer_cache)


def test_update_layer_cache_offsets(rng):
    B, K, S, D, T = 3, 2, 32, 16, 5
    k_layer = jnp.zeros((B, S, K, D), jnp.float32)
    v_layer = jnp.zeros((B, S, K, D), jnp.float32)
    new_k = jnp.asarray(rng.normal(size=(B, T, K, D)).astype(np.float32))
    new_v = jnp.asarray(rng.normal(size=(B, T, K, D)).astype(np.float32))
    starts = jnp.asarray(np.array([0, 7, 20], np.int32))

    k_out, v_out, _, _ = update_layer_cache(k_layer, v_layer, new_k, new_v,
                                            starts)
    k_np, nk = np.asarray(k_out), np.asarray(new_k)
    for b, s in enumerate([0, 7, 20]):
        np.testing.assert_array_equal(k_np[b, s:s + T], nk[b])
        # untouched elsewhere
        assert (k_np[b, :s] == 0).all()
        assert (k_np[b, s + T:] == 0).all()


def test_quantized_cache_roundtrip(rng):
    B, K, S, D, T = 1, 2, 16, 32, 4
    c = new_kv_cache(1, B, K, S, D, quantized=True)
    assert c.quantized and c.k.dtype == jnp.int8
    new_k = jnp.asarray(rng.normal(size=(B, T, K, D)).astype(np.float32))
    new_v = jnp.asarray(rng.normal(size=(B, T, K, D)).astype(np.float32))
    starts = jnp.asarray(np.array([3], np.int32))
    k_out, v_out, ks, vs = update_layer_cache(
        c.k[0], c.v[0], new_k, new_v, starts, c.k_scale[0], c.v_scale[0])
    deq = np.asarray(k_out, np.float32) * np.asarray(ks)[..., None]
    want = np.asarray(new_k)[0]
    np.testing.assert_allclose(deq[0, 3:3 + T], want, atol=0.02)


def test_new_cache_shapes():
    c = new_kv_cache(4, 2, 8, 64, 128, dtype=jnp.bfloat16)
    assert c.k.shape == (4, 2, 64, 8, 128)
    assert c.num_layers == 4 and c.batch_size == 2 and c.max_seq_len == 64
    assert not c.quantized


# ---------------------------------------------------------------------------
# in-place stacked write (update_cache_at_layer)
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import pytest  # noqa: E402

from llm_inference_engine.ops.kv_cache import (  # noqa: E402
    _quantize_kv, update_cache_at_layer)


def _host_write(arr, new, layer, starts, nlen):
    out = np.array(arr)
    for b, (s, n) in enumerate(zip(starts, nlen)):
        out[layer, b, s:s + n] = np.asarray(new)[b, :n]
    return out


@pytest.mark.parametrize("quantized", [False, True])
def test_stacked_write_rows_only(rng, quantized):
    """Only rows t < new_len land, at starts + t, on the written layer: a
    new_len == 0 sequence and the rows past new_len (here in a window that
    ends at the cache's last row) keep their contents — values and, for the
    int8 cache, the scale planes."""
    L, B, S, K, D, T = 2, 4, 32, 2, 16, 8
    cache = new_kv_cache(L, B, K, S, D, dtype=jnp.float32,
                         quantized=quantized)
    fill = jnp.asarray(rng.integers(-50, 50, size=cache.k.shape), cache.k.dtype)
    cache = KVCache(fill, fill, cache.lengths,
                    None if not quantized else cache.k_scale * 3.0,
                    None if not quantized else cache.v_scale * 3.0)
    nk = jnp.asarray(rng.normal(size=(B, T, K, D)).astype(np.float32))
    starts = np.array([0, 5, 11, S - T], np.int32)
    nlen = np.array([T, 0, 3, T // 2], np.int32)
    out = update_cache_at_layer(cache, jnp.int32(1), nk, nk,
                                jnp.asarray(starts), jnp.asarray(nlen))
    vals, sc = (_quantize_kv(nk) if quantized else (nk, None))
    np.testing.assert_array_equal(
        np.asarray(out.k), _host_write(cache.k, vals, 1, starts, nlen))
    if quantized:
        np.testing.assert_array_equal(
            np.asarray(out.k_scale),
            _host_write(cache.k_scale, sc, 1, starts, nlen))
        np.testing.assert_array_equal(
            np.asarray(out.v_scale),
            _host_write(cache.v_scale, sc, 1, starts, nlen))


def test_stacked_write_embedded_scales(rng):
    from llm_inference_engine.ops.kv_cache import quantize_kv_embedded
    L, B, S, K, D, T = 2, 2, 16, 2, 16, 4
    cache = new_kv_cache(L, B, K, S, D, quantized=True, embedded=True)
    nk = jnp.asarray(rng.normal(size=(B, T, K, D)).astype(np.float32))
    starts, nlen = np.array([3, 12], np.int32), np.array([4, 2], np.int32)
    out = update_cache_at_layer(cache, jnp.int32(0), nk, nk,
                                jnp.asarray(starts), jnp.asarray(nlen))
    np.testing.assert_array_equal(
        np.asarray(out.v),
        _host_write(cache.v, quantize_kv_embedded(nk), 0, starts, nlen))


def test_stacked_write_is_in_place():
    """Compiled with the cache donated, the write aliases the cache and
    needs no cache-sized temporary (a batch-vmapped update transposed the
    whole [L, B, ...] array)."""
    L, B, S, K, D, T = 4, 4, 256, 2, 32, 16
    cache = new_kv_cache(L, B, K, S, D, dtype=jnp.float32)
    nk = jnp.zeros((B, T, K, D), jnp.float32)
    compiled = jax.jit(update_cache_at_layer, donate_argnums=0).lower(
        cache, jnp.int32(2), nk, nk, jnp.zeros((B,), jnp.int32),
        jnp.full((B,), T, jnp.int32)).compile()
    ma = compiled.memory_analysis()
    cache_bytes = cache.k.nbytes + cache.v.nbytes
    assert ma.alias_size_in_bytes >= cache_bytes
    assert ma.temp_size_in_bytes < cache.k.nbytes // L
