"""Unit tests: RoPE and the fused QKV-split+RoPE.

Mirrors reference tests/unit_tests/test_qkv_bias_and_rope.cu (CPU RoPE
golden, test_qkv_bias_and_rope.cu:14-60) and the decode-path rope of
src/kernels/rope.cu. Verifies the exact half-split rotation at arbitrary
absolute positions (history offsets).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from llm_inference_engine.ops.rope import apply_rope, split_qkv_rope


def np_rope(x, positions, theta):
    """x: [T, H, D]; positions: [T]."""
    T, H, D = x.shape
    half = D // 2
    inv = 1.0 / (theta ** (np.arange(half) * 2.0 / D))
    ang = positions[:, None].astype(np.float64) * inv       # [T, half]
    cos, sin = np.cos(ang)[:, None, :], np.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          axis=-1)


@pytest.mark.parametrize("T,H,D,offset", [(16, 4, 64, 0), (9, 2, 128, 37)])
def test_apply_rope_matches_numpy(rng, T, H, D, offset):
    x = rng.normal(size=(T, H, D)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32) + offset
    got = np.asarray(apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    want = np_rope(x, pos, 10000.0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_split_qkv_rope_matches_numpy(rng):
    """Group-major packed qkv [T, K*(G+2)*D]: per kv group, G query heads
    then k then v; q and k rotated at their positions, v untouched."""
    T, H, K, D = 13, 8, 2, 64
    G = H // K
    x = rng.normal(size=(T, (H + 2 * K) * D)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32) + 5
    q1, k1, v1 = split_qkv_rope(jnp.asarray(x), jnp.asarray(pos), H, K, D)
    z = x.reshape(T, K, G + 2, D)
    want_q = np_rope(z[:, :, :G].reshape(T, H, D), pos, 10000.0)
    want_k = np_rope(z[:, :, G], pos, 10000.0)
    np.testing.assert_allclose(np.asarray(q1), want_q, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(k1), want_k, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(v1), z[:, :, G + 1], atol=0)


def test_rope_decode_step_matches_prefill(rng):
    """A single-token rope at position p equals row p of a batch rope —
    the prefill/decode split must agree (reference rope.cu vs
    qkv_bias_and_rope.cu consistency)."""
    H, D, T = 4, 64, 12
    x = rng.normal(size=(T, H, D)).astype(np.float32)
    pos = np.arange(T, dtype=np.int32)
    full = np.asarray(apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    for p in (0, 5, 11):
        one = np.asarray(apply_rope(jnp.asarray(x[p:p + 1]),
                                    jnp.asarray(pos[p:p + 1])))
        np.testing.assert_allclose(one[0], full[p], atol=1e-6)


def test_ntk_scaling_config_and_resolution():
    """NTK rope scaling (reference plumbed use_dynamic_ntk config->kernel
    with a placeholder kernel side, model_utils.h:41): HF dict parsing and
    the theta fold at engine context length."""
    from llm_inference_engine.config import (
        ModelConfig, NTKScaling, resolve_rope_scaling)
    cfg = ModelConfig.from_dict({
        "hidden_size": 256, "num_attention_heads": 4,
        "num_hidden_layers": 2, "vocab_size": 128,
        "intermediate_size": 512, "rope_theta": 10000.0,
        "max_position_embeddings": 2048,
        "rope_scaling": {"type": "dynamic", "factor": 4.0,
                         "original_max_position_embeddings": 2048}})
    rs = cfg.rope_scaling
    assert isinstance(rs, NTKScaling) and rs.dynamic and rs.factor == 4.0

    r = resolve_rope_scaling(cfg, max_seq_len=8192)
    assert r.rope_scaling is None
    d = cfg.head_dim
    s = 4.0 * 8192 / 2048 - 3.0                       # = 13.0
    assert r.rope_theta == pytest.approx(10000.0 * s ** (d / (d - 2)))
    # below the original context the dynamic factor clamps to 1 -> theta
    assert resolve_rope_scaling(cfg, 1024).rope_theta == 10000.0

    static = cfg.replace(rope_scaling=NTKScaling(factor=4.0, dynamic=False))
    r2 = resolve_rope_scaling(static, 1024)           # length-independent
    assert r2.rope_theta == pytest.approx(10000.0 * 4.0 ** (d / (d - 2)))


def test_ntk_engine_equals_manual_theta():
    """An NTK-configured engine decodes exactly like one built with the
    folded theta set by hand (and differently from the unscaled one)."""
    from llm_inference_engine.config import (
        EngineConfig, NTKScaling, SamplingParams, get_config,
        resolve_rope_scaling)
    from llm_inference_engine.models.weights import init_dummy_params
    from llm_inference_engine.runtime.engine import InferenceEngine

    base = get_config("debug")
    ntk = base.replace(rope_scaling=NTKScaling(
        factor=4.0, original_max_position_embeddings=16, dynamic=True))
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    prompt = list(range(3, 35))

    def run(cfg):
        eng = InferenceEngine(cfg, EngineConfig(max_batch_size=1,
                                                max_seq_len=64),
                              init_dummy_params(base, seed=0))
        toks = eng.generate([prompt], sp, eos_token_id=None).token_ids[0]
        eng.reset()
        return toks, np.asarray(eng.prefill([prompt]))

    manual = base.replace(
        rope_theta=resolve_rope_scaling(ntk, 64).rope_theta)
    ntk_toks, ntk_logits = run(ntk)
    man_toks, man_logits = run(manual)
    base_toks, base_logits = run(base)
    assert ntk_toks == man_toks
    np.testing.assert_array_equal(ntk_logits, man_logits)
    assert not np.allclose(ntk_logits, base_logits, atol=1e-4)
