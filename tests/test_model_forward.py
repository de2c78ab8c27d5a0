"""Integration tests: full decoder forward — prefill/decode consistency.

The reference's equivalents are the examples/cpp layer drivers (dummy
weights, no asserts, e.g. context_decoder_example.cpp) plus manual tensor
dumps; here the invariant is asserted directly: running a sequence
token-by-token through the decode path (KV cache) must produce the same
logits as prefilling the whole sequence at once — and both must match a
cache-free full-context forward.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from llm_inference_engine.config import EngineConfig, get_config
from llm_inference_engine.models import llama as M
from llm_inference_engine.models.weights import init_dummy_params, quantize_params
from llm_inference_engine.ops import kv_cache as kvc

CFG = get_config("debug")
ENG = EngineConfig(max_batch_size=2, max_seq_len=64)


def _full_context_logits(params, token_ids, upto):
    """Cache-free golden: fresh cache, prefill all, take logits."""
    B, T = token_ids.shape
    cache = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads, ENG.max_seq_len,
                             CFG.head_dim, dtype=CFG.dtype)
    q_start = jnp.zeros((B,), jnp.int32)
    kv_len = jnp.asarray(upto, jnp.int32)
    logits, _ = M.forward_hidden(CFG, ENG, params, token_ids, cache, q_start,
                                 kv_len)
    return np.asarray(logits)


@pytest.fixture(scope="module")
def params():
    return init_dummy_params(CFG, seed=0)


def test_prefill_then_decode_matches_full_context(params, rng):
    B, T = 2, 12
    ids = rng.integers(0, CFG.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.array([12, 9], np.int32)

    # golden: full forward over all T tokens at once
    want = _full_context_logits(params, jnp.asarray(ids), lens)

    # prefill first part, then decode the last 3 tokens one by one
    split = lens - 3
    cache = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                             ENG.max_seq_len, CFG.head_dim, dtype=CFG.dtype)
    q_start = jnp.zeros((B,), jnp.int32)
    logits, cache = M.forward_hidden(CFG, ENG, params, jnp.asarray(ids), cache,
                                     q_start, jnp.asarray(split))
    for step in range(3):
        pos = split + step
        tok = ids[np.arange(B), pos][:, None]          # [B, 1]
        logits, cache = M.forward_hidden(
            CFG, ENG, params, jnp.asarray(tok), cache,
            jnp.asarray(pos), jnp.asarray(pos + 1))
    # after consuming all tokens, decode-path logits == full-context logits
    np.testing.assert_allclose(np.asarray(logits), want, atol=2e-4, rtol=2e-4)


def test_ragged_batch_prefill(params, rng):
    """Sequences of different lengths in one padded batch must each match
    their solo forward."""
    ids_a = rng.integers(0, CFG.vocab_size, size=(1, 10)).astype(np.int32)
    ids_b = rng.integers(0, CFG.vocab_size, size=(1, 6)).astype(np.int32)

    solo_a = _full_context_logits(params, jnp.asarray(ids_a), [10])
    solo_b = _full_context_logits(params, jnp.asarray(ids_b), [6])

    batch = np.zeros((2, 10), np.int32)
    batch[0] = ids_a[0]
    batch[1, :6] = ids_b[0]
    both = _full_context_logits(params, jnp.asarray(batch), [10, 6])

    np.testing.assert_allclose(both[0], solo_a[0], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(both[1], solo_b[0], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_full_forward_matches_reference(params, rng, quant):
    """The production forward (chunked prefill through the cache, then
    decode steps) reproduces the float32 reference forward's logits at
    every position (models/reference.py)."""
    from llm_inference_engine.models.reference import reference_logits
    from llm_inference_engine.models.weights import quantize_params
    p = params if quant == "none" else quantize_params(params, quant, 16)
    ids = rng.integers(0, CFG.vocab_size, size=(2, 12)).astype(np.int32)
    want = np.asarray(reference_logits(CFG, p, ids))           # [2, 12, V]
    cache = kvc.new_kv_cache(CFG.num_layers, 2, CFG.num_kv_heads, 64,
                             CFG.head_dim, dtype=CFG.dtype)
    logits, cache = M.forward_hidden(
        CFG, ENG, p, jnp.asarray(ids[:, :8]), cache,
        jnp.zeros((2,), jnp.int32), jnp.full((2,), 8, jnp.int32))
    got = [np.asarray(logits)]
    for t in range(8, 12):
        logits, cache = M.forward_hidden(
            CFG, ENG, p, jnp.asarray(ids[:, t:t + 1]), cache,
            jnp.full((2,), t, jnp.int32), jnp.full((2,), t + 1, jnp.int32))
        got.append(np.asarray(logits))
    np.testing.assert_allclose(np.stack(got, 1), want[:, 7:], atol=5e-4,
                               rtol=5e-4)


def test_quantized_model_close_to_fp(params, rng):
    """INT8-quantized full forward stays close to fp32 logits."""
    qparams = quantize_params(params, "int8")
    ids = rng.integers(0, CFG.vocab_size, size=(1, 6)).astype(np.int32)

    def logits_of(p):
        cache = kvc.new_kv_cache(CFG.num_layers, 1, CFG.num_kv_heads, 64,
                                 CFG.head_dim, dtype=CFG.dtype)
        l, _ = M.forward_hidden(CFG, ENG, p, jnp.asarray(ids), cache,
                                jnp.zeros((1,), jnp.int32),
                                jnp.asarray([6], jnp.int32))
        return np.asarray(l)

    lf = logits_of(params)
    lq = logits_of(qparams)
    # top-1 agreement and small relative error
    assert lf.argmax() == lq.argmax()
    rel = np.abs(lf - lq).max() / (np.abs(lf).max() + 1e-9)
    assert rel < 0.05, rel
