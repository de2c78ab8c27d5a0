"""Multi-host serving tier: lockstep scheduler + request router.

Single-process semantics: agree_step_plan reduces over this process's
row alone, so MultiHostScheduler must complete the same work as the
plain ContinuousBatchingScheduler; RequestRouter spreads requests over
independent per-host engines. (The multi-process path uses the same
code with jax.distributed initialized — the agreement math is identical,
only the all-gather widens.)
"""

import numpy as np
import pytest

from llm_inference_engine.config import (EngineConfig, SamplingParams,
                                             get_config)
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.parallel.multihost import (StepPlan,
                                                         agree_step_plan)
from llm_inference_engine.runtime.engine import InferenceEngine
from llm_inference_engine.runtime.multihost_scheduler import (
    MultiHostScheduler, RequestRouter)
from llm_inference_engine.runtime.scheduler import (
    ContinuousBatchingScheduler)

CFG = get_config("debug")
EOS = None  # dummy models rarely emit a fixed eos; use length stops


def _engine(batch=3, seq=64):
    eng = EngineConfig(max_batch_size=batch, max_seq_len=seq)
    return InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=0))


def test_agree_step_plan_single_process():
    plan = agree_step_plan(32, 256, True)
    assert plan == StepPlan(prefill_len=32, kv_hi=256, any_work=True)
    plan = agree_step_plan(0, 128, False)
    assert plan.prefill_len == 0 and not plan.any_work


def _submit_all(sched, rng, n=5):
    reqs = []
    for i in range(n):
        ids = rng.integers(0, CFG.vocab_size, size=4 + i).tolist()
        reqs.append(sched.submit(
            ids, SamplingParams(greedy=True, max_new_tokens=6)))
    return reqs


def test_lockstep_matches_plain_scheduler(rng):
    rng_a = np.random.default_rng(7)
    rng_b = np.random.default_rng(7)
    plain = ContinuousBatchingScheduler(_engine(), eos_token_id=EOS)
    lock = MultiHostScheduler(_engine(), eos_token_id=EOS)
    ra = _submit_all(plain, rng_a)
    rb = _submit_all(lock, rng_b)
    fa = plain.run()
    fb = lock.run()
    assert len(fa) == len(fb) == 5
    for a, b in zip(ra, rb):
        assert a.output_ids == b.output_ids, (a.id, a.output_ids, b.output_ids)
        assert a.finish_reason == b.finish_reason


def test_lockstep_long_prompt_watermark(rng):
    """Regression: the agreed kv watermark must cover lengths AFTER the
    admission prefill. A 300-token prompt against the 256-token watermark
    floor previously decoded with attention truncated at 256 (wrong
    tokens): attention reads only rows below kv_hi."""
    rng_a = np.random.default_rng(3)
    rng_b = np.random.default_rng(3)

    def engine():
        eng = EngineConfig(max_batch_size=1, max_seq_len=512)
        return InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=0))

    ids = rng_a.integers(0, CFG.vocab_size, size=300).tolist()
    assert (rng_b.integers(0, CFG.vocab_size, size=300).tolist() == ids)
    plain = ContinuousBatchingScheduler(engine(), eos_token_id=EOS)
    lock = MultiHostScheduler(engine(), eos_token_id=EOS)
    ra = plain.submit(ids, SamplingParams(greedy=True, max_new_tokens=4))
    rb = lock.submit(ids, SamplingParams(greedy=True, max_new_tokens=4))
    plain.run()
    lock.run()
    assert ra.output_ids == rb.output_ids


def test_lockstep_idle_host_terminates():
    """No submissions: the first agreed plan has any_work False and the
    loop exits after one lockstep round."""
    lock = MultiHostScheduler(_engine(), eos_token_id=EOS)
    assert lock.run(max_steps=10) == []


def test_router_least_loaded_and_completion(rng):
    hosts = [ContinuousBatchingScheduler(_engine(batch=2), eos_token_id=EOS)
             for _ in range(2)]
    router = RequestRouter(hosts)
    reqs = [router.submit(rng.integers(0, CFG.vocab_size, size=5).tolist(),
                          SamplingParams(greedy=True, max_new_tokens=4))
            for _ in range(6)]
    # round-robin-ish: both hosts got work
    assert all(len(h.waiting) + h.num_active > 0 for h in hosts)
    finished = router.run()
    assert len(finished) == 6
    assert all(r.finished and len(r.output_ids) == 4 for r in reqs)


def test_router_rejects_empty():
    with pytest.raises(ValueError):
        RequestRouter([])


def test_lockstep_chunked_admission_no_stall():
    """Long prompts admit chunk-by-chunk in the lockstep scheduler; a live
    decode slot advances every mixed step, and tokens match the plain
    scheduler on the same engine shapes."""
    eng_kwargs = dict(batch=2, seq=96)
    lock = MultiHostScheduler(_engine(**eng_kwargs), eos_token_id=None)
    lock.engine.engine_config = lock.engine.engine_config.replace(
        max_prefill_len=8)
    sp = SamplingParams(greedy=True, max_new_tokens=10)
    a = lock.submit([1, 2, 3], sp)
    lock.step()
    long_prompt = list(range(3, 3 + 24))      # 3 chunks of 8
    b = lock.submit(long_prompt, sp)
    grew = []
    for _ in range(3):
        n0 = len(a.output_ids)
        lock.step()
        grew.append(len(a.output_ids) - n0)
    assert grew == [1, 1, 1]
    assert b.prefill_pos is None and len(b.output_ids) == 1
    lock.run()

    plain = ContinuousBatchingScheduler(_engine(**eng_kwargs),
                                        eos_token_id=None)
    plain.engine.engine_config = plain.engine.engine_config.replace(
        max_prefill_len=8)
    ra = plain.submit([1, 2, 3], sp)
    plain.step()
    rb = plain.submit(long_prompt, sp)
    plain.run()
    assert b.output_ids == rb.output_ids
    assert a.output_ids == ra.output_ids
