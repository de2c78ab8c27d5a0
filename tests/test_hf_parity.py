"""End-to-end logits parity against the HuggingFace Llama reference.

The reference engine's correctness story stopped at per-kernel unit tests
(SURVEY.md §4); the intended end-to-end check ("compare against HF
output", src/tools/HF_llama_run_script.py referenced but absent from its
tree) never existed. Here it does: a small random HF LlamaForCausalLM is
saved to safetensors, loaded through THIS engine's native checkpoint
pipeline (fused layouts, [out,in]->[in,out] canonicalization), and its
logits must match transformers' eager forward on the same tokens —
covering the loader, every kernel, RoPE conventions, GQA grouping, and
the KV-cache path (prefill == HF, incremental decode == HF with past).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp

from llm_inference_engine.config import EngineConfig, ModelConfig
from llm_inference_engine.models import llama as M
from llm_inference_engine.models.weights import load_hf_safetensors
from llm_inference_engine.ops import kv_cache as kvc


@pytest.fixture(scope="module")
def hf_setup(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    hf_cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(0)
    model = LlamaForCausalLM(hf_cfg).eval()
    ckpt = tmp_path_factory.mktemp("hf_ckpt")
    model.save_pretrained(str(ckpt), safe_serialization=True)

    cfg = ModelConfig(
        name="hf-tiny", vocab_size=128, hidden_size=64,
        intermediate_size=128, num_layers=3, num_heads=4, num_kv_heads=2,
        head_dim=16, rms_norm_eps=1e-5, rope_theta=10000.0,
        max_position_embeddings=128, dtype_name="float32")
    params = load_hf_safetensors(cfg, str(ckpt), dtype=jnp.float32)
    return model, cfg, params


def _ours_logits(cfg, params, ids, incremental=False):
    eng = EngineConfig(max_batch_size=ids.shape[0], max_seq_len=64)
    cache = kvc.new_kv_cache(cfg.num_layers, ids.shape[0], cfg.num_kv_heads,
                             64, cfg.head_dim, dtype=jnp.float32)
    B, T = ids.shape
    if not incremental:
        hidden, _ = M.decoder_forward(
            cfg, eng, params, jnp.asarray(ids), cache,
            jnp.zeros((B,), jnp.int32), jnp.full((B,), T, jnp.int32))
        return np.asarray(M.lm_head_logits(cfg, eng, params, hidden)
                          if hidden.ndim == 2 else
                          _all_logits(cfg, eng, params, hidden))
    # token-by-token through the KV cache
    outs = []
    for t in range(T):
        hidden, cache = M.decoder_forward(
            cfg, eng, params, jnp.asarray(ids[:, t:t + 1]), cache,
            jnp.full((B,), t, jnp.int32), jnp.full((B,), t + 1, jnp.int32))
        outs.append(_all_logits(cfg, eng, params, hidden)[:, 0])
    return np.stack(outs, axis=1)


def _all_logits(cfg, eng, params, hidden):
    return np.asarray(M.lm_head_logits(cfg, eng, params, hidden))


def test_prefill_logits_match_hf(hf_setup, rng):
    model, cfg, params = hf_setup
    ids = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int64)
    with torch.no_grad():
        hf = model(torch.from_numpy(ids)).logits.numpy()
    ours = _ours_logits(cfg, params, ids.astype(np.int32))
    np.testing.assert_allclose(ours, hf, atol=2e-4, rtol=2e-4)


def test_incremental_decode_matches_hf(hf_setup, rng):
    model, cfg, params = hf_setup
    ids = rng.integers(0, cfg.vocab_size, size=(1, 9)).astype(np.int64)
    with torch.no_grad():
        hf = model(torch.from_numpy(ids)).logits.numpy()
    ours = _ours_logits(cfg, params, ids.astype(np.int32), incremental=True)
    np.testing.assert_allclose(ours, hf, atol=3e-4, rtol=3e-4)


def test_greedy_tokens_match_hf(hf_setup, rng):
    model, cfg, params = hf_setup
    from llm_inference_engine.config import SamplingParams
    from llm_inference_engine.runtime.engine import InferenceEngine
    prompt = rng.integers(0, cfg.vocab_size, size=(6,)).tolist()
    with torch.no_grad():
        hf_out = model.generate(
            torch.tensor([prompt]), max_new_tokens=8, do_sample=False,
            pad_token_id=0)
    hf_tokens = hf_out[0, len(prompt):].tolist()
    engine = InferenceEngine(
        cfg, EngineConfig(max_batch_size=1, max_seq_len=64),
        params)
    r = engine.generate([prompt], SamplingParams(greedy=True,
                                                 max_new_tokens=8),
                        eos_token_id=None)
    assert r.token_ids[0] == hf_tokens
