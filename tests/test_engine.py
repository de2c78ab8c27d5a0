"""Integration tests: InferenceEngine generation loop.

Mirrors the reference's response() loop semantics (llama.cpp:322-398):
prefill -> iterative decode -> EOS/length stop -> streaming callback,
plus multi-round history in the KV cache.
"""

import numpy as np
import pytest

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.engine import InferenceEngine

CFG = get_config("debug")


@pytest.fixture(scope="module")
def engine():
    eng = EngineConfig(max_batch_size=2, max_seq_len=64)
    params = init_dummy_params(CFG, seed=0)
    return InferenceEngine(CFG, eng, params)


def test_greedy_generation_deterministic(engine):
    engine.reset()
    sp = SamplingParams(greedy=True, max_new_tokens=8)
    r1 = engine.generate([[1, 5, 9]], sp, eos_token_id=None)
    engine.reset()
    r2 = engine.generate([[1, 5, 9]], sp, eos_token_id=None)
    assert r1.token_ids == r2.token_ids
    assert len(r1.token_ids[0]) == 8


def test_batch_generation(engine):
    engine.reset()
    sp = SamplingParams(greedy=True, max_new_tokens=5)
    r = engine.generate([[1, 2, 3], [4, 5, 6, 7, 8]], sp, eos_token_id=None)
    assert len(r.token_ids) == 2
    assert r.num_prompt_tokens == [3, 5]
    # batch results must equal solo results (slot isolation)
    engine.reset()
    solo0 = engine.generate([[1, 2, 3]], sp, eos_token_id=None)
    assert r.token_ids[0] == solo0.token_ids[0]


def test_streaming_callback(engine):
    engine.reset()
    seen = []
    sp = SamplingParams(greedy=True, max_new_tokens=4)
    r = engine.generate([[1, 2]], sp, eos_token_id=None,
                        stream_callback=lambda i, t: seen.append((i, t)))
    assert [t for _, t in seen] == r.token_ids[0]


def test_eos_stops(engine):
    engine.reset()
    sp = SamplingParams(greedy=True, max_new_tokens=20)
    free = engine.generate([[1, 2, 3]], sp, eos_token_id=None)
    # use the first generated token as the "EOS": generation must stop at 0
    eos = free.token_ids[0][1]
    engine.reset()
    r = engine.generate([[1, 2, 3]], sp, eos_token_id=eos)
    assert len(r.token_ids[0]) < len(free.token_ids[0])


def test_multi_round_history(engine):
    """Round 2 prefill must append to cached history, matching a single
    prefill of the concatenation (multi-round chat, llama.cpp:137-155)."""
    sp = SamplingParams(greedy=True, max_new_tokens=3)
    engine.reset()
    r1 = engine.generate([[1, 2, 3]], sp, eos_token_id=None)
    round2_prompt = [7, 8]
    r2 = engine.generate([round2_prompt], sp, eos_token_id=None)

    # same conversation replayed as one flat prompt
    engine.reset()
    flat = [1, 2, 3] + r1.token_ids[0] + round2_prompt
    r_flat = engine.generate([flat], sp, eos_token_id=None)
    assert r2.token_ids[0] == r_flat.token_ids[0]

    # stronger than token equality: the round-2 LOGITS must equal the flat
    # replay's (regression: a length-terminated round's final token was
    # silently missing from the cache, skewing every later round)
    def fresh():
        return InferenceEngine(
            CFG, EngineConfig(max_batch_size=1, max_seq_len=64),
            init_dummy_params(CFG, seed=0))

    e1, e2 = fresh(), fresh()
    ra = e1.generate([[1, 2, 3]], sp, eos_token_id=None)
    assert int(np.asarray(e1.cache.lengths)[0]) == 3 + len(ra.token_ids[0])
    l_inc = e1.prefill([round2_prompt], slots=[0])
    l_flat = e2.prefill([[1, 2, 3] + ra.token_ids[0] + round2_prompt],
                        slots=[0])
    np.testing.assert_allclose(np.asarray(l_inc), np.asarray(l_flat),
                               rtol=1e-5, atol=1e-5)


def test_sampled_generation_runs(engine):
    engine.reset()
    sp = SamplingParams(temperature=0.8, top_k=5, top_p=0.9, max_new_tokens=6)
    r = engine.generate([[1, 2, 3]], sp, eos_token_id=None)
    assert 0 < len(r.token_ids[0]) <= 6
    assert all(0 <= t < CFG.vocab_size for t in r.token_ids[0])


def test_chunked_prefill_matches_single_shot():
    """Prompts longer than max_prefill_len run as several chunked forward
    passes; logits must equal the single-shot prefill."""
    import dataclasses
    import numpy as np
    import jax.numpy as jnp
    from llm_inference_engine.config import EngineConfig, get_config
    from llm_inference_engine.models.weights import init_dummy_params
    from llm_inference_engine.runtime.engine import InferenceEngine

    cfg = get_config("debug")
    params = init_dummy_params(cfg, seed=0, scale=0.3)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (37, 5, 23)]

    def logits_with(prefill_chunk):
        eng = EngineConfig(max_batch_size=3, max_seq_len=64,
                           max_prefill_len=prefill_chunk)
        engine = InferenceEngine(cfg, eng, params)
        return np.asarray(engine.prefill(prompts))

    single = logits_with(64)
    chunked = logits_with(8)
    np.testing.assert_allclose(chunked, single, atol=1e-4, rtol=1e-4)


def _fresh_engine():
    eng = EngineConfig(max_batch_size=2, max_seq_len=64)
    return InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=0))


def test_sampled_rollout_matches_streamed_loop_greedy():
    """generate() without a stream_callback runs the one-call device
    rollout; greedy results must equal the per-token streamed loop."""
    engine = _fresh_engine()
    sp = SamplingParams(greedy=True, max_new_tokens=9)
    seen = []
    r_loop = engine.generate([[1, 5, 9], [2, 4]], sp, eos_token_id=None,
                             stream_callback=lambda i, t: seen.append((i, t)))
    engine.reset()
    r_roll = engine.generate([[1, 5, 9], [2, 4]], sp, eos_token_id=None)
    assert r_roll.token_ids == r_loop.token_ids
    assert seen  # the loop actually streamed


def test_sampled_rollout_deterministic_and_stops():
    """Same-seed engines produce identical sampled rollouts; stop ids
    terminate rows device-side."""
    a = _fresh_engine()
    b = _fresh_engine()
    sp = SamplingParams(temperature=0.8, top_k=5, max_new_tokens=12)
    ra = a.generate([[3, 7]], sp, eos_token_id=None)
    rb = b.generate([[3, 7]], sp, eos_token_id=None)
    assert ra.token_ids == rb.token_ids
    assert all(0 <= t for t in ra.token_ids[0])

    # force an early stop: use the first sampled token as the stop id
    c = _fresh_engine()
    probe = c.generate([[3, 7]], sp, eos_token_id=None)
    stop = probe.token_ids[0][1]
    c.reset()
    d = _fresh_engine()
    r = d.generate([[3, 7]], SamplingParams(
        temperature=0.8, top_k=5, max_new_tokens=12,
        stop_token_ids=(stop,)), eos_token_id=None)
    assert stop not in r.token_ids[0]
    assert len(r.token_ids[0]) < 12


def test_multiround_append_near_capacity_matches_flat_replay(rng):
    """r4 review: a padded prefill chunk whose window crossed max_seq_len
    had its write start clamped, shifting real rows onto older valid
    history (silent corruption). The engine now shrinks the chunk bucket
    near capacity; appends at history 48 and 52 of a 64-slot cache must
    reproduce a one-shot prefill of the same 56 tokens exactly."""
    from llm_inference_engine.config import EngineConfig, get_config
    from llm_inference_engine.models.weights import init_dummy_params
    from llm_inference_engine.runtime.engine import InferenceEngine
    cfg = get_config("debug")
    params = init_dummy_params(cfg, seed=0)
    eng = EngineConfig(max_batch_size=1, max_seq_len=64, max_prefill_len=16)
    toks = rng.integers(0, cfg.vocab_size, size=56).tolist()

    e = InferenceEngine(cfg, eng, params)
    e.prefill([toks[:48]])
    e.prefill([toks[48:52]])
    got = np.asarray(e.prefill([toks[52:56]]))

    e2 = InferenceEngine(cfg, eng, params)
    want = np.asarray(e2.prefill([toks]))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)

    # completely-full appends still refuse loudly instead of corrupting
    import pytest as _pytest
    e.prefill([toks[:8]], slots=[0])          # now at 64 = max_seq_len
    with _pytest.raises(ValueError, match="cannot fit"):
        e.prefill([[1]], slots=[0])


def test_prefill_exact_fit_tail_and_mixed_batch_split(rng):
    """r4 review: (a) an append that FITS but has no power-of-two bucket
    below the remaining room must be served with an exact-fit tail
    bucket (13 tokens into 14 remaining rows); (b) a mixed batch of a
    near-capacity append and a long fresh admission must split into
    separate calls instead of refusing."""
    from llm_inference_engine.config import EngineConfig, get_config
    from llm_inference_engine.models.weights import init_dummy_params
    from llm_inference_engine.runtime.engine import InferenceEngine
    cfg = get_config("debug")
    params = init_dummy_params(cfg, seed=0)

    # (a) exact-fit tail
    eng = EngineConfig(max_batch_size=1, max_seq_len=64, max_prefill_len=16)
    toks = rng.integers(0, cfg.vocab_size, size=63).tolist()
    e = InferenceEngine(cfg, eng, params)
    e.prefill([toks[:50]])
    got = np.asarray(e.prefill([toks[50:63]]))        # 13 @ history 50
    e2 = InferenceEngine(cfg, eng, params)
    want = np.asarray(e2.prefill([toks]))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)

    # (b) mixed near-capacity append + long admission in ONE call
    eng2 = EngineConfig(max_batch_size=2, max_seq_len=64,
                        max_prefill_len=32)
    e3 = InferenceEngine(cfg, eng2, params)
    a = rng.integers(0, cfg.vocab_size, size=44).tolist()
    b = rng.integers(0, cfg.vocab_size, size=32).tolist()
    e3.prefill([a[:40]], slots=[0])
    got = np.asarray(e3.prefill([a[40:44], b], slots=[0, 1]))
    e4 = InferenceEngine(cfg, eng2, params)
    e4.prefill([a[:40]], slots=[0])
    w0 = np.asarray(e4.prefill([a[40:44]], slots=[0]))
    w1 = np.asarray(e4.prefill([b], slots=[1]))
    np.testing.assert_allclose(got[0], w0[0], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got[1], w1[1], atol=2e-4, rtol=2e-4)
