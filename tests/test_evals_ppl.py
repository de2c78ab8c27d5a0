"""Perplexity harness tests (evals/ppl.py).

Validates the windowed teacher-forced scorer against a direct
full-sequence log-likelihood computation, checks windowing invariance,
and runs the fp-vs-quantized delta report — the machinery behind the
BASELINE.md WikiText-2 gates (INT8 <= +0.1 PPL, INT4 <= +0.5 PPL).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_inference_engine.config import EngineConfig, get_config
from llm_inference_engine.evals.ppl import Scorer, perplexity, quant_ppl_report
from llm_inference_engine.models import llama as M
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.ops import kv_cache as kvc


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("debug")
    params = init_dummy_params(cfg, seed=0, scale=0.2)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=201).tolist()
    return cfg, params, tokens


def _direct_nll(cfg, params, tokens):
    """Golden: single full-sequence forward, NLL of tokens[1:]."""
    eng = EngineConfig(max_batch_size=1, max_seq_len=len(tokens))
    cache = kvc.new_kv_cache(cfg.num_layers, 1, cfg.num_kv_heads,
                             len(tokens), cfg.head_dim, dtype=cfg.dtype)
    ids = jnp.asarray([tokens], jnp.int32)
    n = jnp.array([len(tokens)], jnp.int32)
    hidden, _ = M.decoder_forward(cfg, eng, params, ids, cache,
                                  jnp.zeros((1,), jnp.int32), n)
    logits = M.lm_head_logits(cfg, eng, params, hidden)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    lp = jnp.take_along_axis(logp[0, :-1], ids[0, 1:, None], -1)[:, 0]
    return float(-jnp.sum(lp)), len(tokens) - 1


def test_scorer_matches_direct(setup):
    cfg, params, tokens = setup
    want_nll, want_n = _direct_nll(cfg, params, tokens)
    # window larger than the stream: one window, exact match
    nll, n = Scorer(cfg, params, EngineConfig(),
                    window=256, batch=2).score(tokens)
    assert n == want_n
    assert nll == pytest.approx(want_nll, rel=1e-4)


def test_windowing_counts_every_token_once(setup):
    cfg, params, tokens = setup
    # small windows: every token except the first predicted exactly once
    nll, n = Scorer(cfg, params, EngineConfig(),
                    window=64, batch=3).score(tokens)
    assert n == len(tokens) - 1
    assert math.isfinite(nll) and nll > 0
    # batch size must not change the result
    nll2, n2 = Scorer(cfg, params, EngineConfig(),
                      window=64, batch=1).score(tokens)
    assert n2 == n
    assert nll2 == pytest.approx(nll, rel=1e-4)


def test_uniform_model_ppl_is_vocab_size(setup):
    cfg, _, tokens = setup
    # zero-scale weights -> uniform logits -> PPL == vocab size
    params = init_dummy_params(cfg, seed=0, scale=0.0)
    ppl = perplexity(cfg, params, tokens,
                     EngineConfig(), window=128, batch=2)
    assert ppl == pytest.approx(cfg.vocab_size, rel=1e-3)


def test_quant_ppl_report(setup):
    cfg, params, tokens = setup
    rep = quant_ppl_report(cfg, params, tokens[:101], modes=("int8",),
                           group_size=32, window=128, batch=1,
                           engine_config=EngineConfig())
    assert rep["fp"] > 1.0
    assert math.isfinite(rep["int8"])
    # int8 weight-only on a tiny random model stays close to fp
    assert abs(rep["int8_delta"]) < 0.05 * rep["fp"]
