"""Continuous batching scheduler tests.

No reference counterpart (bs pinned to 1, llama.h:31) — invariants tested:
slot multiplexing correctness (same results as solo runs), admission under
load, mixed sampling params, completion reasons.
"""

import numpy as np
import pytest

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.engine import InferenceEngine
from llm_inference_engine.runtime.scheduler import ContinuousBatchingScheduler

CFG = get_config("debug")


def make_engine(batch=2, seq=48):
    eng = EngineConfig(max_batch_size=batch, max_seq_len=seq)
    return InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=0))


def test_more_requests_than_slots():
    engine = make_engine(batch=2)
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    sp = SamplingParams(greedy=True, max_new_tokens=5)
    reqs = [sched.submit([1 + i, 2 + i, 3 + i], sp) for i in range(5)]
    finished = sched.run()
    assert len(finished) == 5
    assert all(r.finished and r.finish_reason == "length" for r in reqs)
    assert all(len(r.output_ids) == 5 for r in reqs)


def test_matches_solo_generation():
    """Requests interleaved through 2 slots must produce exactly what each
    produces alone (KV isolation + per-slot sampling)."""
    prompts = [[1, 2, 3], [9, 8, 7, 6], [4, 4], [17, 5, 30, 2, 8]]
    sp = SamplingParams(greedy=True, max_new_tokens=6)

    solo = []
    for p in prompts:
        e = make_engine(batch=1)
        s = ContinuousBatchingScheduler(e, eos_token_id=None)
        r = s.submit(p, sp)
        s.run()
        solo.append(r.output_ids)

    e = make_engine(batch=2)
    s = ContinuousBatchingScheduler(e, eos_token_id=None)
    reqs = [s.submit(p, sp) for p in prompts]
    s.run()
    assert [r.output_ids for r in reqs] == solo


def test_mixed_sampling_params():
    engine = make_engine(batch=2)
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    greedy = sched.submit([1, 2, 3], SamplingParams(greedy=True,
                                                    max_new_tokens=4))
    sampled = sched.submit([1, 2, 3],
                           SamplingParams(temperature=1.5, top_k=8,
                                          max_new_tokens=4))
    sched.run()
    assert greedy.finished and sampled.finished
    # greedy result must equal the solo greedy result regardless of the
    # sampled neighbor
    e = make_engine(batch=1)
    s = ContinuousBatchingScheduler(e, eos_token_id=None)
    r = s.submit([1, 2, 3], SamplingParams(greedy=True, max_new_tokens=4))
    s.run()
    assert greedy.output_ids == r.output_ids


def test_streaming_and_slot_reuse():
    engine = make_engine(batch=1)
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    seen = []
    sp = SamplingParams(greedy=True, max_new_tokens=3)
    r1 = sched.submit([5, 6], sp, stream_callback=lambda t: seen.append(t))
    r2 = sched.submit([7, 8], sp)
    sched.run()
    assert seen == r1.output_ids
    assert r2.finished and len(r2.output_ids) == 3


def test_rejects_oversized_prompt():
    engine = make_engine(batch=1, seq=16)
    sched = ContinuousBatchingScheduler(engine)
    r = sched.submit(list(range(40)), SamplingParams(max_new_tokens=4))
    assert r.finished and r.finish_reason == "rejected"
    assert not sched.has_work


def test_capacity_finish():
    engine = make_engine(batch=1, seq=16)
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    r = sched.submit([1, 2, 3, 4, 5, 6],
                     SamplingParams(greedy=True, max_new_tokens=100))
    sched.run()
    assert r.finish_reason == "capacity"
    # total tokens bounded by cache capacity
    assert len(r.prompt_ids) + len(r.output_ids) <= 15


def test_chunked_admission_does_not_stall_decodes():
    """A long prompt admits chunk-by-chunk in MIXED steps: the already-
    decoding slot must gain one token per step throughout (no head-of-line
    blocking), and the result must equal running the same request alone."""
    eng = EngineConfig(max_batch_size=2, max_seq_len=96,
                       max_prefill_len=8)
    engine = InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=0))
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    sp = SamplingParams(greedy=True, max_new_tokens=12)

    a = sched.submit([1, 2, 3], sp)
    sched.step()                        # A prefills, gets first token
    long_prompt = list(range(3, 3 + 28))  # 4 chunks of 8
    b = sched.submit(long_prompt, sp)
    grew = []
    for _ in range(4):                  # B's chunked admission steps
        n0 = len(a.output_ids)
        sched.step()
        grew.append(len(a.output_ids) - n0)
    assert b.prefill_pos is None        # B finished prefilling
    assert len(b.output_ids) == 1      # first token sampled on last chunk
    assert grew == [1, 1, 1, 1]        # A advanced every mixed step
    sched.run()

    # same tokens as an uncontended run of the long request
    engine2 = InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=0))
    solo = ContinuousBatchingScheduler(engine2, eos_token_id=None)
    rb = solo.submit(long_prompt, sp)
    solo.run()
    assert rb.output_ids == b.output_ids


def test_cancellation_waiting_and_inflight():
    """Cancelling a waiting request removes it before it ever runs;
    cancelling an in-flight request frees the slot for the next admission
    and other requests are unaffected (tokens match an uncontended run)."""
    engine = make_engine(batch=2)
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    sp = SamplingParams(greedy=True, max_new_tokens=8)

    a = sched.submit([1, 2, 3], sp)
    b = sched.submit([9, 8, 7], sp)
    c = sched.submit([4, 5, 6], sp)      # waits (2 slots)
    assert sched.cancel(c)
    assert c.finish_reason == "cancelled" and not c.output_ids

    sched.step()
    assert sched.cancel(b)               # in-flight: slot frees
    assert b.finish_reason == "cancelled"
    d = sched.submit([11, 12], sp)
    sched.run()
    assert d.finished and len(d.output_ids) == 8
    assert not sched.cancel(d)           # already finished -> False

    solo = ContinuousBatchingScheduler(make_engine(batch=1),
                                       eos_token_id=None)
    ra = solo.submit([1, 2, 3], sp)
    solo.run()
    assert a.output_ids == ra.output_ids


def test_latency_accounting():
    engine = make_engine(batch=2)
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    r = sched.submit([1, 2, 3], SamplingParams(greedy=True, max_new_tokens=4))
    assert r.ttft is None and r.e2e_latency is None
    sched.run()
    assert r.ttft is not None and r.ttft >= 0
    assert r.e2e_latency >= r.ttft
    rej = sched.submit(list(range(100)), SamplingParams())
    assert rej.finish_reason == "rejected" and rej.e2e_latency == 0.0


def test_per_slot_penalties_isolated():
    """Slot A runs with an extreme repetition penalty (all outputs
    distinct), slot B without — and B's tokens are untouched by A's
    penalty state (per-slot count planes)."""
    engine = make_engine(batch=2)
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    a = sched.submit([5, 7, 5], SamplingParams(
        greedy=True, max_new_tokens=6, repetition_penalty=1e9))
    b = sched.submit([9, 8, 7], SamplingParams(greedy=True,
                                               max_new_tokens=6))
    sched.run()
    out_a = a.output_ids
    assert len(set(out_a) | {5, 7}) == len(out_a) + 2

    solo = ContinuousBatchingScheduler(make_engine(batch=1),
                                       eos_token_id=None)
    rb = solo.submit([9, 8, 7], SamplingParams(greedy=True,
                                               max_new_tokens=6))
    solo.run()
    assert b.output_ids == rb.output_ids
