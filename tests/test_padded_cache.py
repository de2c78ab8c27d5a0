"""Tile-padded KV cache (ops/kv_cache.aligned_kv_dims) numerics.

A cache may be allocated with (num_kv_heads, head_dim) rounded up to an
(8, 128) tile (``new_kv_cache(pad_to_tiles=True)``) — TinyLlama is K=4,
D=64; the model layer zero-pads queries/new tokens and slices the attention
output back (models/llama.py). These tests pin the invariant that padding
is exact: the padded-cache forward equals the unpadded one
bit-for-tolerance, across prefill, decode, GQA/MHA and quantized caches.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from llm_inference_engine.config import EngineConfig, get_config
from llm_inference_engine.models import llama as M
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.ops import kv_cache as kvc

CFG = get_config("debug")     # num_heads=4, num_kv_heads=2, head_dim=16


def test_aligned_kv_dims():
    assert kvc.aligned_kv_dims(4, 64) == (8, 128)      # TinyLlama
    assert kvc.aligned_kv_dims(32, 128) == (32, 128)   # Llama2-7B: no-op
    assert kvc.aligned_kv_dims(8, 128) == (8, 128)     # Mistral: no-op
    assert kvc.aligned_kv_dims(1, 200) == (8, 256)


def _run(params, ids, lens, *, pad, quantized=False, decode_tail=0):
    eng = EngineConfig(max_batch_size=ids.shape[0], max_seq_len=64)
    cache = kvc.new_kv_cache(
        CFG.num_layers, ids.shape[0], CFG.num_kv_heads, eng.max_seq_len,
        CFG.head_dim, dtype=CFG.dtype, quantized=quantized, pad_to_tiles=pad)
    if pad:
        Kp, Dp = kvc.aligned_kv_dims(CFG.num_kv_heads, CFG.head_dim)
        assert cache.k.shape[-2:] == (Kp, Dp)
    q_start = jnp.zeros((ids.shape[0],), jnp.int32)
    split = np.asarray(lens) - decode_tail
    logits, cache = M.forward_hidden(CFG, eng, params, jnp.asarray(ids),
                                     cache, q_start, jnp.asarray(split))
    for step in range(decode_tail):
        pos = split + step
        tok = ids[np.arange(ids.shape[0]), pos][:, None]
        logits, cache = M.forward_hidden(
            CFG, eng, params, jnp.asarray(tok), cache,
            jnp.asarray(pos), jnp.asarray(pos + 1))
    return np.asarray(logits)


@pytest.fixture(scope="module")
def params():
    return init_dummy_params(CFG, seed=0)


def test_padded_prefill_matches_unpadded(params, rng):
    ids = rng.integers(0, CFG.vocab_size, size=(2, 10)).astype(np.int32)
    lens = [10, 7]
    want = _run(params, ids, lens, pad=False)
    got = _run(params, ids, lens, pad=True)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_padded_decode_matches_unpadded(params, rng):
    ids = rng.integers(0, CFG.vocab_size, size=(2, 12)).astype(np.int32)
    lens = [12, 9]
    want = _run(params, ids, lens, pad=False, decode_tail=3)
    got = _run(params, ids, lens, pad=True, decode_tail=3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_padded_quantized_cache_matches_unpadded(params, rng):
    """INT8 KV cache (separate per-token scales) under padding: pad heads
    are all-zero, quantize to zeros with the clamp floor, dequant to zero."""
    ids = rng.integers(0, CFG.vocab_size, size=(1, 8)).astype(np.int32)
    want = _run(params, ids, [8], pad=False, quantized=True,
                decode_tail=2)
    got = _run(params, ids, [8], pad=True, quantized=True,
               decode_tail=2)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_mha_padded_matches_unpadded(rng):
    """MHA (H == K) under padding: one query head per (padded) kv head."""
    cfg = CFG.replace(num_heads=2, num_kv_heads=2)
    params = init_dummy_params(cfg, seed=1)
    ids = rng.integers(0, cfg.vocab_size, size=(1, 6)).astype(np.int32)

    def run(pad):
        eng = EngineConfig(max_batch_size=1, max_seq_len=32)
        cache = kvc.new_kv_cache(cfg.num_layers, 1, cfg.num_kv_heads, 32,
                                 cfg.head_dim, dtype=cfg.dtype,
                                 pad_to_tiles=pad)
        logits, cache = M.forward_hidden(
            cfg, eng, params, jnp.asarray(ids), cache,
            jnp.zeros((1,), jnp.int32), jnp.asarray([5], jnp.int32))
        logits, _ = M.forward_hidden(
            cfg, eng, params, jnp.asarray(ids[:, 5:6]), cache,
            jnp.asarray([5], jnp.int32), jnp.asarray([6], jnp.int32))
        return np.asarray(logits)

    np.testing.assert_allclose(run(True), run(False), atol=2e-5, rtol=2e-5)
