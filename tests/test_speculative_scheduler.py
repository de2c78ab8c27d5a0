"""Speculative continuous batching (runtime/speculative_scheduler.py).

The lossless property under serving: whatever the draft model proposes,
the emitted tokens equal the plain greedy continuous-batching scheduler's
token for token — across multiplexed requests, chunked admissions mixing
with live decodes, and slot reuse. Pinned with an identical draft (100%
acceptance) and a disagreeing draft (partial acceptance).
"""

import numpy as np
import pytest

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.engine import InferenceEngine
from llm_inference_engine.runtime.scheduler import ContinuousBatchingScheduler
from llm_inference_engine.runtime.speculative_scheduler import (
    SpeculativeScheduler)

CFG = get_config("debug")


def _engine(seed=0, batch=2, seq=96, prefill=8):
    eng = EngineConfig(max_batch_size=batch, max_seq_len=seq,
                       max_prefill_len=prefill)
    return InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=seed))


def _run(sched, prompts, sp):
    reqs = [sched.submit(p, sp) for p in prompts]
    sched.run(max_steps=2000)
    return [r.output_ids for r in reqs]


PROMPTS = [[1, 2, 3], [9, 8, 7, 6], list(range(3, 25)), [4, 4], [17, 5]]


@pytest.mark.parametrize("draft_seed", [0, 1])
def test_spec_scheduler_matches_plain_greedy(draft_seed):
    sp = SamplingParams(greedy=True, max_new_tokens=9)
    want = _run(ContinuousBatchingScheduler(_engine(), eos_token_id=None),
                PROMPTS, sp)
    spec = SpeculativeScheduler(_engine(), _engine(seed=draft_seed),
                                eos_token_id=None, num_draft=3)
    got = _run(spec, PROMPTS, sp)
    assert got == want
    assert spec.num_drafted > 0
    if draft_seed == 0:
        assert spec.acceptance_rate == 1.0     # identical draft
    else:
        assert spec.acceptance_rate < 1.0      # disagreeing draft


def test_spec_scheduler_chunked_admission_mixes_with_rounds():
    """A long prompt admits chunk-by-chunk while a live request decodes
    (plain tokens during mixed steps, spec rounds between) — and the
    result still matches the plain scheduler."""
    sp = SamplingParams(greedy=True, max_new_tokens=12)
    plain = ContinuousBatchingScheduler(_engine(), eos_token_id=None)
    a0 = plain.submit([1, 2, 3], sp)
    plain.step()
    b0 = plain.submit(list(range(3, 31)), sp)
    plain.run()

    spec = SpeculativeScheduler(_engine(), _engine(seed=1),
                                eos_token_id=None, num_draft=3)
    a = spec.submit([1, 2, 3], sp)
    spec.step()
    b = spec.submit(list(range(3, 31)), sp)
    spec.run(max_steps=2000)
    assert a.output_ids == a0.output_ids
    assert b.output_ids == b0.output_ids


def test_spec_scheduler_sampled_and_penalized_requests_run():
    """Sampled submissions are accepted (stochastic acceptance rule,
    tests/test_speculative_sampled.py), and penalized submissions run
    under the frozen-counts round semantics (VERDICT r3 #8)."""
    spec = SpeculativeScheduler(_engine(), _engine(), eos_token_id=None)
    r_pen = spec.submit([1, 2, 3], SamplingParams(temperature=0.8,
                                                  frequency_penalty=0.2,
                                                  max_new_tokens=5))
    r = spec.submit([1, 2, 3], SamplingParams(temperature=0.8,
                                              max_new_tokens=6))
    spec.run(max_steps=500)
    assert r.finished and len(r.output_ids) == 6
    assert r_pen.finished and len(r_pen.output_ids) == 5


def test_spec_scheduler_eos_and_capacity():
    """EOS inside an accepted run stops that request mid-emission; a
    near-cap request finishes with 'capacity'."""
    spec = SpeculativeScheduler(_engine(seq=32), _engine(seq=32),
                                eos_token_id=None, num_draft=3)
    sp = SamplingParams(greedy=True, max_new_tokens=100)
    r = spec.submit([1, 2, 3], sp)
    spec.run(max_steps=2000)
    assert r.finished and r.finish_reason == "capacity"
    # k+2 headroom: total context stays within max_seq
    assert 3 + len(r.output_ids) <= 32

    # eos: pick a token the model actually emits and make it the stop id
    probe = SpeculativeScheduler(_engine(), _engine(), eos_token_id=None)
    q = probe.submit([1, 2, 3], SamplingParams(greedy=True,
                                               max_new_tokens=6))
    probe.run(max_steps=2000)
    eos = q.output_ids[3]
    first = q.output_ids.index(eos)           # tokens may repeat
    spec2 = SpeculativeScheduler(_engine(), _engine(), eos_token_id=eos)
    r2 = spec2.submit([1, 2, 3], SamplingParams(greedy=True,
                                                max_new_tokens=6))
    spec2.run(max_steps=2000)
    assert r2.finish_reason == "eos"
    assert r2.output_ids == q.output_ids[:first]


def test_spec_scheduler_logprobs_match_plain():
    """Spec rounds attach target logprobs to every accepted token —
    identical to the plain scheduler's values (review finding: rounds
    left token_logprobs sparse and misaligned)."""
    sp = SamplingParams(greedy=True, max_new_tokens=8)
    plain = ContinuousBatchingScheduler(_engine(), eos_token_id=None)
    p = plain.submit([1, 2, 3], sp)
    plain.run()
    spec = SpeculativeScheduler(_engine(), _engine(seed=1),
                                eos_token_id=None, num_draft=3)
    s = spec.submit([1, 2, 3], sp)
    spec.run(max_steps=500)
    assert s.output_ids == p.output_ids
    assert len(s.token_logprobs) == len(s.output_ids)
    np.testing.assert_allclose(s.token_logprobs, p.token_logprobs,
                               rtol=1e-4, atol=1e-5)


def test_spec_scheduler_prefix_caching_dual_restore():
    """Prefix caching under speculative scheduling (VERDICT r2 ask #6):
    the paired snapshot restores into BOTH caches, so a cache-hit request
    generates exactly what a cold one does."""
    prefix = list(range(1, 25))
    tails = [[30, 31, 32], [40, 41]]
    sp = SamplingParams(greedy=True, max_new_tokens=8)

    cold = SpeculativeScheduler(_engine(), _engine(seed=1),
                                eos_token_id=None, num_draft=3)
    want = _run(cold, [prefix + t for t in tails], sp)

    warm = SpeculativeScheduler(_engine(), _engine(seed=1),
                                eos_token_id=None, num_draft=3)
    entry = warm.register_prefix(prefix)
    assert entry.length == len(prefix)
    reqs = [warm.submit(prefix + t, sp) for t in tails]
    warm.run(max_steps=2000)
    assert [r.output_ids for r in reqs] == want
    # the prefix was actually reused, not recomputed
    assert all(r.reused_prefix_len == len(prefix) for r in reqs)
