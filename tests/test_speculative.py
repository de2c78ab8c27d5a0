"""Speculative decoding: greedy spec output must EXACTLY equal the
target's plain greedy output (the lossless acceptance rule), regardless of
how good the draft model is."""

import numpy as np
import pytest

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.engine import InferenceEngine
from llm_inference_engine.runtime.speculative import SpeculativeDecoder

CFG = get_config("debug")


def _greedy(engine, prompts, n):
    engine.reset()
    r = engine.generate(prompts, SamplingParams(greedy=True,
                                                max_new_tokens=n),
                        eos_token_id=None)
    return r.token_ids


@pytest.mark.parametrize("draft_seed,min_rate", [
    (0, 0.99),   # draft == target: every draft accepted
    (5, 0.0),    # unrelated draft: still exact output, low acceptance
])
def test_greedy_spec_exact(draft_seed, min_rate):
    eng = EngineConfig(max_batch_size=2, max_seq_len=96)
    t_params = init_dummy_params(CFG, seed=0, scale=0.3)
    d_params = init_dummy_params(CFG, seed=draft_seed, scale=0.3)
    target = InferenceEngine(CFG, eng, t_params)
    draft = InferenceEngine(CFG, eng, d_params)

    prompts = [[1, 17, 93, 5], [1, 9, 41]]
    want = _greedy(target, prompts, 16)

    spec = SpeculativeDecoder(target, draft, num_draft=3)
    res = spec.generate(prompts, max_new_tokens=16, eos_token_id=None)
    assert res.token_ids == want, (res.token_ids, want)
    assert res.acceptance_rate >= min_rate
    if draft_seed == 0:
        # identical models must accept every drafted token
        assert res.num_accepted == res.num_drafted


def test_spec_with_eos():
    eng = EngineConfig(max_batch_size=1, max_seq_len=96)
    params = init_dummy_params(CFG, seed=3, scale=0.35)
    target = InferenceEngine(CFG, eng, params)
    draft = InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=4,
                                                        scale=0.35))
    prompt = [[1, 2, 3]]
    base = _greedy(target, prompt, 24)[0]
    # pick a token appearing in the greedy output as fake EOS
    eos = base[min(7, len(base) - 1)]
    want = base[:base.index(eos) + 1] if eos in base else base

    target.reset()
    spec = SpeculativeDecoder(target, draft, num_draft=4)
    res = spec.generate(prompt, max_new_tokens=24, eos_token_id=int(eos))
    assert res.token_ids[0] == want
