"""Beam-search tests (runtime/beam_search.py).

The reference declared beam hooks it never wired (launchTopKForBeamSearch,
topk.cu:104-140; beamwidth, llama.h:42). Validates here:
- beam=1 equals greedy decoding;
- wider beams never score worse than greedy (teacher-forced log-prob);
- reported scores equal independently recomputed sequence log-probs;
- EOS freezing and best-first ordering.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models import llama as M
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.ops import kv_cache as kvc
from llm_inference_engine.runtime.beam_search import beam_search
from llm_inference_engine.runtime.engine import InferenceEngine


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("debug")
    params = init_dummy_params(cfg, seed=3, scale=0.35)
    eng = EngineConfig(max_batch_size=4, max_seq_len=64)
    return cfg, eng, params


def _seq_logprob(cfg, params, prompt, generated):
    """Teacher-forced log P(generated | prompt), single full forward."""
    full = list(prompt) + list(generated)
    eng = EngineConfig(max_batch_size=1, max_seq_len=len(full))
    cache = kvc.new_kv_cache(cfg.num_layers, 1, cfg.num_kv_heads, len(full),
                             cfg.head_dim, dtype=cfg.dtype)
    ids = jnp.asarray([full], jnp.int32)
    hidden, _ = M.decoder_forward(cfg, eng, params, ids, cache,
                                  jnp.zeros((1,), jnp.int32),
                                  jnp.array([len(full)], jnp.int32))
    logits = M.lm_head_logits(cfg, eng, params, hidden)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)[0]
    total = 0.0
    for i, tok in enumerate(generated):
        total += float(logp[len(prompt) - 1 + i, tok])
    return total


def test_beam1_equals_greedy(setup):
    cfg, eng, params = setup
    prompt = [1, 9, 41, 7]
    engine = InferenceEngine(cfg, eng, params)
    greedy = engine.generate([prompt],
                             SamplingParams(greedy=True, max_new_tokens=8),
                             eos_token_id=None).token_ids[0]
    res = beam_search(cfg, eng, params, prompt, num_beams=1,
                      max_new_tokens=8, eos_token_id=None)
    assert res.sequences[0] == greedy


def test_beam_score_matches_recompute(setup):
    cfg, eng, params = setup
    prompt = [1, 23, 5]
    res = beam_search(cfg, eng, params, prompt, num_beams=3,
                      max_new_tokens=6, eos_token_id=None,
                      length_penalty=0.0)
    # with length_penalty 0 the reported score is the raw sum log-prob
    for seq, score in zip(res.sequences, res.scores):
        want = _seq_logprob(cfg, params, prompt, seq)
        assert score == pytest.approx(want, abs=2e-3)
    # best-first ordering
    assert res.scores == sorted(res.scores, reverse=True)


def test_beam_beats_or_ties_greedy(setup):
    cfg, eng, params = setup
    prompt = [1, 13, 99, 2, 7]
    engine = InferenceEngine(cfg, eng, params)
    greedy = engine.generate([prompt],
                             SamplingParams(greedy=True, max_new_tokens=6),
                             eos_token_id=None).token_ids[0]
    g_score = _seq_logprob(cfg, params, prompt, greedy)
    res = beam_search(cfg, eng, params, prompt, num_beams=4,
                      max_new_tokens=6, eos_token_id=None,
                      length_penalty=0.0)
    assert res.scores[0] >= g_score - 1e-3


def test_beam_eos_freezing(setup):
    cfg, eng, params = setup
    prompt = [1, 2, 3]
    # pick the greedy first token as a fake EOS so beams finish immediately
    engine = InferenceEngine(cfg, eng, params)
    first = engine.generate([prompt],
                            SamplingParams(greedy=True, max_new_tokens=1),
                            eos_token_id=None).token_ids[0][0]
    res = beam_search(cfg, eng, params, prompt, num_beams=3,
                      max_new_tokens=6, eos_token_id=first)
    # at least one beam finished on the eos token (greedy continuation);
    # a frozen beam contains eos exactly once, as its final token, and is
    # never extended past it
    eos_seqs = [s for s in res.sequences if first in s]
    assert eos_seqs, "no beam picked the greedy eos token"
    for s in eos_seqs:
        assert s.count(first) == 1
        assert s[-1] == first
    assert all(len(s) <= 6 for s in res.sequences)
