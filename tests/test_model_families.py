"""Model-family breadth: sliding-window attention (Mistral-class) and qkv
projection bias (Qwen2-class).

The reference is Llama2-only; its QKV+RoPE kernel carried a bias input it
never used (qkv_bias_and_rope.cu:97) — implemented here. Golden checks:
brute-force numpy SWA mask, production-vs-reference attention, and end-to-end HF
logits parity for tiny random Mistral / Qwen2 checkpoints through the full
loader + forward + KV-cache path (same harness as test_hf_parity.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from llm_inference_engine.config import EngineConfig, ModelConfig, get_config
from llm_inference_engine.models import llama as M
from llm_inference_engine.ops import kv_cache as kvc
from llm_inference_engine.ops.attention import attention, attention_ref


# ---------------------------------------------------------------------------
# kernel-level sliding window
# ---------------------------------------------------------------------------

def _naive_swa(q, k, v, q_start, kv_len, window):
    """Brute-force sliding-window attention (float64 softmax)."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    out = np.zeros_like(q, dtype=np.float64)
    for b in range(B):
        for i in range(Sq):
            p = q_start[b] + i
            for h in range(H):
                kh = h // G
                js = [j for j in range(kv_len[b])
                      if j <= p and j > p - window]
                if not js:
                    continue
                s = np.array([q[b, i, h] @ k[b, j, kh] for j in js],
                             np.float64) / np.sqrt(D)
                e = np.exp(s - s.max())
                w = e / e.sum()
                out[b, i, h] = sum(wj * v[b, j, kh]
                                   for wj, j in zip(w, js))
    return out


def test_swa_xla_vs_naive(rng):
    B, Sq, H, K, D, S = 2, 5, 4, 2, 8, 24
    W = 6
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    q_start = np.array([3, 9], np.int32)
    kv_len = np.array([8, 14], np.int32)
    ours = np.asarray(attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(q_start), jnp.asarray(kv_len), window=W))
    ref = _naive_swa(q, k, v, q_start, kv_len, W)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_swa_prefill_vs_reference(rng):
    B, Sq, H, K, D, S = 2, 12, 4, 2, 16, 64
    W = 10
    q = jnp.asarray(rng.standard_normal((B, Sq, H, D)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((B, S, K, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, S, K, D)), jnp.float32)
    qs = jnp.asarray(np.array([0, 20], np.int32))
    kl = jnp.asarray(np.array([12, 32], np.int32))
    a = attention(q, k, v, qs, kl, window=W)
    b = attention_ref(q, k, v, qs, kl, window=W)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=2e-5, atol=2e-5)


def test_swa_decode_vs_reference(rng):
    """Decode with a window, bounded by kv_hi: in-window keys only."""
    B, H, K, D, S = 2, 8, 8, 128, 64
    W = 24
    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((B, S, K, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, S, K, D)), jnp.float32)
    kl = jnp.asarray(np.array([40, 9], np.int32))
    qs = kl - 1
    a = attention(q, k, v, qs, kl, window=W, kv_hi=48)
    b = attention_ref(q, k, v, qs, kl, window=W)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------

def test_presets_and_hf_config_quirks():
    assert get_config("mistral-7b").sliding_window == 4096
    assert get_config("qwen2-7b").attention_bias

    cfg = ModelConfig.from_dict({
        "model_type": "qwen2", "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "hidden_size": 64, "sliding_window": 4096,
        "use_sliding_window": False})
    assert cfg.attention_bias and cfg.sliding_window is None

    cfg = ModelConfig.from_dict({"model_type": "mistral",
                                 "sliding_window": 1024})
    assert cfg.sliding_window == 1024 and not cfg.attention_bias


# ---------------------------------------------------------------------------
# end-to-end HF parity (tiny random checkpoints through the real loader)
# ---------------------------------------------------------------------------

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")


def _hf_round_trip(tmp_path, hf_model, our_cfg, ids):
    """Save the HF model, load through our pipeline, compare prefill
    logits at every position and incremental single-token decode."""
    from llm_inference_engine.models.weights import load_hf_safetensors

    ckpt = tmp_path / "ckpt"
    hf_model.save_pretrained(str(ckpt), safe_serialization=True)
    params = load_hf_safetensors(our_cfg, str(ckpt), dtype=jnp.float32)

    with torch.no_grad():
        ref = hf_model(torch.from_numpy(ids)).logits.numpy()

    eng = EngineConfig(max_batch_size=ids.shape[0], max_seq_len=64)
    B, T = ids.shape

    def fresh_cache():
        return kvc.new_kv_cache(our_cfg.num_layers, B, our_cfg.num_kv_heads,
                                64, our_cfg.head_dim, dtype=jnp.float32)

    logits, _ = M.forward_all_logits(
        our_cfg, eng, params, jnp.asarray(ids), fresh_cache(),
        jnp.zeros((B,), jnp.int32), jnp.full((B,), T, jnp.int32))
    np.testing.assert_allclose(np.asarray(logits), ref, rtol=2e-4, atol=2e-4)

    # incremental decode through the KV cache must match HF's per-position
    # prefill logits (exercises the decode-side window mask / bias path)
    cache = fresh_cache()
    for t in range(T):
        step_logits, cache = M.forward_all_logits(
            our_cfg, eng, params, jnp.asarray(ids[:, t:t + 1]), cache,
            jnp.full((B,), t, jnp.int32), jnp.full((B,), t + 1, jnp.int32))
        np.testing.assert_allclose(np.asarray(step_logits[:, 0]), ref[:, t],
                                   rtol=2e-4, atol=2e-4)


def test_mistral_sliding_window_parity(tmp_path, rng):
    from transformers import MistralConfig, MistralForCausalLM

    hf_cfg = MistralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        sliding_window=6, tie_word_embeddings=False,
        attn_implementation="eager")
    torch.manual_seed(1)
    model = MistralForCausalLM(hf_cfg).eval()

    cfg = ModelConfig.from_dict(hf_cfg.to_dict()).replace(
        name="mistral-tiny", head_dim=16, dtype_name="float32")
    assert cfg.sliding_window == 6
    ids = rng.integers(0, 128, size=(2, 16)).astype(np.int64)  # > window
    _hf_round_trip(tmp_path, model, cfg, ids)


def test_llama31_rope_scaling_parity(tmp_path, rng):
    """Llama-3.1 frequency-dependent RoPE scaling (HF rope_type
    "llama3") matches transformers end to end."""
    from transformers import LlamaConfig, LlamaForCausalLM

    hf_cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 16},
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(3)
    model = LlamaForCausalLM(hf_cfg).eval()

    cfg = ModelConfig.from_dict(hf_cfg.to_dict()).replace(
        name="llama31-tiny", head_dim=16, dtype_name="float32")
    from llm_inference_engine.config import RopeScaling
    assert isinstance(cfg.rope_scaling, RopeScaling)
    # positions beyond original_max_position_embeddings exercise the
    # low-frequency slowed bands
    ids = rng.integers(0, 128, size=(2, 24)).astype(np.int64)
    _hf_round_trip(tmp_path, model, cfg, ids)


def test_rope_scaling_matches_numpy(rng):
    """llama3 frequency-dependent scaling against a float64 numpy rotation
    with the HF formula for the scaled inverse frequencies."""
    from llm_inference_engine.config import RopeScaling
    from llm_inference_engine.ops.rope import apply_rope

    rs = RopeScaling(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                     original_max_position_embeddings=32)
    x = jnp.asarray(rng.standard_normal((2, 6, 4, 16)), jnp.float32)
    pos = jnp.asarray(rng.integers(0, 120, size=(2, 6)), jnp.int32)
    a = apply_rope(x, pos, theta=10000.0, scaling=rs)
    D = 16
    inv = 1.0 / 10000.0 ** (np.arange(D // 2) * 2.0 / D)
    wavelen = 2 * np.pi / inv
    orig = rs.original_max_position_embeddings
    smooth = np.clip((orig / wavelen - rs.low_freq_factor)
                     / (rs.high_freq_factor - rs.low_freq_factor), 0, 1)
    inv = np.where(wavelen < orig / rs.high_freq_factor, inv,
                   np.where(wavelen > orig / rs.low_freq_factor,
                            inv / rs.factor,
                            (1 - smooth) * inv / rs.factor + smooth * inv))
    ang = np.asarray(pos, np.float64)[..., None, None] * inv   # [2,6,1,8]
    xn = np.asarray(x, np.float64)
    x1, x2 = xn[..., :D // 2], xn[..., D // 2:]
    b = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                        x2 * np.cos(ang) + x1 * np.sin(ang)], axis=-1)
    np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5, atol=1e-5)
    assert get_config("llama3.1-8b").rope_scaling is not None


def test_qwen2_bias_parity(tmp_path, rng):
    from transformers import Qwen2Config, Qwen2ForCausalLM

    hf_cfg = Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        use_sliding_window=False, tie_word_embeddings=False,
        attn_implementation="eager")
    torch.manual_seed(2)
    model = Qwen2ForCausalLM(hf_cfg).eval()

    cfg = ModelConfig.from_dict(hf_cfg.to_dict()).replace(
        name="qwen2-tiny", head_dim=16, dtype_name="float32")
    assert cfg.attention_bias and cfg.sliding_window is None
    ids = rng.integers(0, 128, size=(2, 12)).astype(np.int64)
    _hf_round_trip(tmp_path, model, cfg, ids)


def test_tied_embeddings_parity(tmp_path, rng):
    """tie_word_embeddings=True checkpoints (no lm_head.weight tensor in
    the file: the loader reuses the embedding) match HF end to end."""
    from transformers import LlamaConfig, LlamaForCausalLM

    hf_cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=True, attn_implementation="eager")
    torch.manual_seed(4)
    model = LlamaForCausalLM(hf_cfg).eval()

    cfg = ModelConfig.from_dict(hf_cfg.to_dict()).replace(
        name="tied-tiny", head_dim=16, dtype_name="float32")
    assert cfg.tie_word_embeddings
    ids = rng.integers(0, 128, size=(2, 10)).astype(np.int64)
    _hf_round_trip(tmp_path, model, cfg, ids)
