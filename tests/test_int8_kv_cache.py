"""INT8 KV cache end-to-end: quantize-on-write + dequant-in-attention.

Part of the quantization goal the reference never reached (README.md:36-39).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models import llama as M
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.ops import kv_cache as kvc
from llm_inference_engine.ops.attention import attention, attention_ref
from llm_inference_engine.runtime.engine import InferenceEngine

CFG = get_config("debug")


def test_attention_with_int8_cache_close_to_fp(rng):
    B, Sq, H, K, D, S = 2, 6, 4, 2, 64, 32
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    kf = rng.normal(size=(B, S, K, D)).astype(np.float32)
    vf = rng.normal(size=(B, S, K, D)).astype(np.float32)
    # quantize per (b, s, k)
    ks = np.abs(kf).max(-1) / 127.0
    vs = np.abs(vf).max(-1) / 127.0
    k8 = np.clip(np.round(kf / ks[..., None]), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(vf / vs[..., None]), -127, 127).astype(np.int8)

    qs = np.array([0, 10], np.int32)
    kl = np.array([6, 16], np.int32)
    want = attention_ref(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf),
                         jnp.asarray(qs), jnp.asarray(kl))
    got = attention(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                    jnp.asarray(qs), jnp.asarray(kl),
                    k_scale=jnp.asarray(ks.astype(np.float32)),
                    v_scale=jnp.asarray(vs.astype(np.float32)))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=0.05,
                               rtol=0.05)


def test_model_forward_int8_cache_close_to_fp():
    # local rng: with the session-shared fixture the token draw depends on
    # suite order, and fp-vs-int8-cache argmax equality is legitimately
    # marginal for some draws on a random model
    rng = np.random.default_rng(7)
    params = init_dummy_params(CFG, seed=0)
    eng = EngineConfig(max_batch_size=1, max_seq_len=32)
    ids = rng.integers(0, CFG.vocab_size, size=(1, 10)).astype(np.int32)

    def run(quantized):
        cache = kvc.new_kv_cache(CFG.num_layers, 1, CFG.num_kv_heads, 32,
                                 CFG.head_dim, dtype=CFG.dtype,
                                 quantized=quantized)
        logits, _ = M.forward_hidden(CFG, eng, params, jnp.asarray(ids),
                                     cache, jnp.zeros((1,), jnp.int32),
                                     jnp.asarray([10], jnp.int32))
        return np.asarray(logits)

    lf = run(False)
    lq = run(True)
    assert lf.argmax() == lq.argmax()
    rel = np.abs(lf - lq).max() / (np.abs(lf).max() + 1e-9)
    assert rel < 0.05, rel


def test_engine_generate_with_int8_cache(rng):
    eng = EngineConfig(max_batch_size=1, max_seq_len=48,
                       kv_cache_dtype_name="int8")
    engine = InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=0))
    assert engine.cache.quantized
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    r = engine.generate([[1, 2, 3, 4]], sp, eos_token_id=None)
    assert len(r.token_ids[0]) == 6

    # must roughly track the fp-cache engine (same weights, same prompt)
    eng2 = EngineConfig(max_batch_size=1, max_seq_len=48)
    engine2 = InferenceEngine(CFG, eng2, init_dummy_params(CFG, seed=0))
    r2 = engine2.generate([[1, 2, 3, 4]], sp, eos_token_id=None)
    # first token comes from prefill logits; int8 cache noise may diverge
    # the sequence later, but the first token must match
    assert r.token_ids[0][0] == r2.token_ids[0][0]


def test_embedded_scale_roundtrip(rng):
    """Embedded log2-scale codes dequantize exactly to the snapped scale."""
    from llm_inference_engine.ops.kv_cache import (
        EMBED_PAD, decode_embedded_scales, quantize_kv_embedded)
    x = rng.normal(size=(2, 5, 8, 128)).astype(np.float32) * 3.0
    packed = quantize_kv_embedded(jnp.asarray(x))
    assert packed.shape == (2, 5, 8 + EMBED_PAD, 128)
    scales = decode_embedded_scales(packed[:, :, 8, :], 8)      # [2,5,8]
    deq = np.asarray(packed[:, :, :8].astype(np.float32)) * \
        np.asarray(scales)[..., None]
    np.testing.assert_allclose(deq, x, atol=np.abs(x).max() / 100)


def test_attention_embedded_matches_separate_scales(rng):
    """Embedded-scale attention == separate-scale attention on the same
    quantized values, and both match the f32 reference."""
    from llm_inference_engine.ops.kv_cache import (
        decode_embedded_scales, quantize_kv_embedded)
    B, S, K, D = 2, 16, 8, 128
    kf = rng.normal(size=(B, S, K, D)).astype(np.float32)
    vf = rng.normal(size=(B, S, K, D)).astype(np.float32)
    packed_k = quantize_kv_embedded(jnp.asarray(kf))
    packed_v = quantize_kv_embedded(jnp.asarray(vf))
    q = jnp.asarray(rng.normal(size=(B, 1, K, D)).astype(np.float32))
    qs = jnp.asarray(np.array([4, 15], np.int32))
    kl = qs + 1

    emb = attention(q, packed_k, packed_v, qs, kl,
                    embedded_kv=True)
    ks = decode_embedded_scales(packed_k[:, :, K, :], K)
    vs = decode_embedded_scales(packed_v[:, :, K, :], K)
    sep = attention(q, packed_k[:, :, :K], packed_v[:, :, :K], qs, kl, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(np.asarray(emb), np.asarray(sep),
                               atol=1e-5, rtol=1e-5)
    # and the f32 reference over the same embedded rows
    embr = attention_ref(q, packed_k, packed_v, qs, kl, embedded_kv=True)
    np.testing.assert_allclose(np.asarray(embr), np.asarray(emb),
                               atol=1.5e-2, rtol=1.5e-2)


def test_engine_embedded_cache_forward(rng):
    """Full forward with an embedded-scale cache tracks the fp-cache
    forward (uses a config meeting the alignment requirements)."""
    from llm_inference_engine.config import ModelConfig
    cfg = ModelConfig(name="emb-test", vocab_size=128, hidden_size=128,
                      intermediate_size=256, num_layers=2, num_heads=8,
                      num_kv_heads=8, head_dim=128, dtype_name="float32")
    params = init_dummy_params(cfg, seed=1)
    eng = EngineConfig(max_batch_size=1, max_seq_len=32)
    ids = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1, 10)).astype(np.int32)

    def run(quantized, embedded):
        cache = kvc.new_kv_cache(cfg.num_layers, 1, cfg.num_kv_heads, 32,
                                 cfg.head_dim, dtype=cfg.dtype,
                                 quantized=quantized, embedded=embedded)
        logits, _ = M.forward_hidden(cfg, eng, params, jnp.asarray(ids),
                                     cache, jnp.zeros((1,), jnp.int32),
                                     jnp.asarray([10], jnp.int32))
        return np.asarray(logits)

    lf = run(False, None)
    lq = run(True, True)
    assert lf.argmax() == lq.argmax()
    rel = np.abs(lf - lq).max() / (np.abs(lf).max() + 1e-9)
    assert rel < 0.05, rel


@pytest.mark.parametrize("fmt", ["f32_scale", "log2_scale"])
def test_reference_int8_rounding_matches_cache_formats(rng, fmt):
    """The reference forward's int8 KV rounding (models/reference.py) gives
    the values the slot cache (float32 scales) and the paged pool
    (log2-coded embedded scales) store."""
    from llm_inference_engine.models.reference import _int8_round_trip
    K = 4
    x = jnp.asarray(rng.normal(size=(2, 5, K, 64)) * 3.0, jnp.float32)
    got = np.asarray(_int8_round_trip(x, fmt))
    if fmt == "f32_scale":
        q, s = kvc._quantize_kv(x)
    else:
        e = kvc.quantize_kv_embedded(x)
        q, s = e[:, :, :K], kvc.decode_embedded_scales(e[:, :, K], K)
    want = np.asarray(q, np.float32) * np.asarray(s)[..., None]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
