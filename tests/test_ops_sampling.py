"""Unit tests: top-K selection + sampling tail.

Mirrors reference tests/unit_tests/test_topk.cu and test_sampling.cu
(print-and-inspect there, topk.cu:12-15 — upgraded to statistical asserts).
"""

import numpy as np
import jax
import jax.numpy as jnp

from llm_inference_engine.ops.sampling import (
    greedy_sample, sample_top_k, top_k_logits)


def test_top_k_matches_numpy(rng):
    logits = rng.normal(size=(4, 1000)).astype(np.float32)
    vals, idx = top_k_logits(jnp.asarray(logits), 5)
    want = np.sort(logits, axis=-1)[:, ::-1][:, :5]
    np.testing.assert_allclose(np.asarray(vals), want, atol=1e-6)


def test_greedy(rng):
    logits = rng.normal(size=(3, 50)).astype(np.float32)
    got = np.asarray(greedy_sample(jnp.asarray(logits)))
    np.testing.assert_array_equal(got, logits.argmax(-1))


def test_sample_top_k_support(rng):
    """Samples must come only from the top-K set."""
    logits = rng.normal(size=(2, 100)).astype(np.float32)
    topk = set(np.argsort(logits[0])[::-1][:5]) | {-1}
    key = jax.random.PRNGKey(0)
    for i in range(20):
        key, sub = jax.random.split(key)
        s = np.asarray(sample_top_k(jnp.asarray(logits), sub, top_k=5))
        assert s[0] in set(np.argsort(logits[0])[::-1][:5])
        assert s[1] in set(np.argsort(logits[1])[::-1][:5])


def test_sample_distribution(rng):
    """With one dominant logit, sampling should pick it almost always."""
    logits = np.full((1, 100), -10.0, np.float32)
    logits[0, 42] = 10.0
    key = jax.random.PRNGKey(1)
    hits = 0
    for i in range(50):
        key, sub = jax.random.split(key)
        hits += int(np.asarray(
            sample_top_k(jnp.asarray(logits), sub, top_k=5))[0] == 42)
    assert hits >= 49


def test_temperature_zero_is_greedy(rng):
    logits = rng.normal(size=(2, 64)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    s = np.asarray(sample_top_k(jnp.asarray(logits), key, temperature=0.0))
    np.testing.assert_array_equal(s, logits.argmax(-1))


def test_apply_penalties_neutral_is_identity(rng):
    from llm_inference_engine.ops.sampling import apply_penalties
    B, V = 3, 50
    logits = jnp.asarray(rng.standard_normal((B, V)), jnp.float32)
    cc = jnp.asarray(rng.integers(0, 4, size=(B, V)), jnp.int32)
    cg = jnp.asarray(rng.integers(0, 4, size=(B, V)), jnp.int32)
    out = apply_penalties(logits, cc, cg,
                          jnp.ones((B,)), jnp.zeros((B,)), jnp.zeros((B,)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(logits))


def test_apply_penalties_math(rng):
    from llm_inference_engine.ops.sampling import apply_penalties
    logits = jnp.asarray([[2.0, -2.0, 1.0, 0.5]], jnp.float32)
    cc = jnp.asarray([[1, 1, 0, 0]], jnp.int32)    # seen in context
    cg = jnp.asarray([[1, 0, 2, 0]], jnp.int32)    # generated counts
    out = np.asarray(apply_penalties(
        logits, cc, cg, jnp.asarray([2.0]), jnp.asarray([0.25]),
        jnp.asarray([0.5])))
    # tok0: seen -> 2/2=1; freq 1*0.5; pres 0.25 -> 0.25
    # tok1: seen, negative -> -2*2=-4
    # tok2: seen via gen -> 1/2=0.5; freq 2*0.5=1; pres 0.25 -> -0.75
    # tok3: unseen -> 0.5
    np.testing.assert_allclose(out[0], [0.25, -4.0, -0.75, 0.5], atol=1e-6)


def test_min_p_filters_tail(rng):
    from llm_inference_engine.ops.sampling import sample_tokens
    # two strong candidates, a weak tail; min_p=0.5 restricts the draw to
    # the two strong ones at any key
    logits = jnp.asarray([[5.0, 5.0] + [0.0] * 30], jnp.float32)
    hits = set()
    for s in range(24):
        t = sample_tokens(logits, jax.random.PRNGKey(s),
                          jnp.asarray([1.0]), jnp.asarray([32]),
                          jnp.asarray([1.0]), min_p=jnp.asarray([0.5]))
        hits.add(int(np.asarray(t)[0]))
    assert hits <= {0, 1} and len(hits) == 2


def test_engine_counts_and_repetition_penalty():
    from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
    from llm_inference_engine.models.weights import init_dummy_params
    from llm_inference_engine.runtime.engine import InferenceEngine
    cfg = get_config("debug")
    eng = InferenceEngine(
        cfg, EngineConfig(max_batch_size=2, max_seq_len=64),
        init_dummy_params(cfg, seed=0))
    prompt = [5, 7, 5]
    r = eng.generate([prompt], SamplingParams(greedy=True, max_new_tokens=6),
                     eos_token_id=None)
    # counts bookkeeping: ctx = prompt + generated, gen = generated only
    cc = np.asarray(eng._counts_ctx)[0]
    cg = np.asarray(eng._counts_gen)[0]
    from collections import Counter
    want_gen = Counter(r.token_ids[0])
    want_ctx = Counter(prompt) + want_gen
    for tok, n in want_ctx.items():
        assert cc[tok] == n, (tok, n, cc[tok])
    assert cc.sum() == len(prompt) + len(r.token_ids[0])
    for tok, n in want_gen.items():
        assert cg[tok] == n
    assert cg.sum() == len(r.token_ids[0])

    # an extreme repetition penalty forbids reusing any seen token: with
    # greedy decode all 6 outputs + the 2 distinct prompt ids are distinct
    eng.reset()
    r2 = eng.generate([prompt],
                      SamplingParams(greedy=True, max_new_tokens=6,
                                     repetition_penalty=1e9),
                      eos_token_id=None)
    out2 = r2.token_ids[0]
    assert len(set(out2) | {5, 7}) == len(out2) + 2


def test_token_logprobs_math(rng):
    from llm_inference_engine.ops.sampling import token_logprobs
    logits = jnp.asarray(rng.standard_normal((3, 20)), jnp.float32)
    ids = jnp.asarray([4, 0, 19], jnp.int32)
    got = np.asarray(token_logprobs(logits, ids))
    ref = np.log(jax.nn.softmax(np.asarray(logits), axis=-1))
    want = ref[np.arange(3), np.asarray(ids)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_generate_and_scheduler_logprobs_consistent():
    """Greedy logprobs from generate() and from the continuous-batching
    scheduler agree for the same prompt (same penalized distribution)."""
    from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
    from llm_inference_engine.models.weights import init_dummy_params
    from llm_inference_engine.runtime.engine import InferenceEngine
    from llm_inference_engine.runtime.scheduler import (
        ContinuousBatchingScheduler)
    cfg = get_config("debug")

    def mk():
        return InferenceEngine(
            cfg, EngineConfig(max_batch_size=1, max_seq_len=64),
            init_dummy_params(cfg, seed=0))
    sp = SamplingParams(greedy=True, max_new_tokens=5)
    r = mk().generate([[1, 2, 3]], sp, eos_token_id=None)
    assert len(r.logprobs[0]) == 5
    assert all(l <= 0.0 for l in r.logprobs[0])

    sched = ContinuousBatchingScheduler(mk(), eos_token_id=None)
    q = sched.submit([1, 2, 3], sp)
    sched.run()
    assert q.output_ids == r.token_ids[0]
    np.testing.assert_allclose(q.token_logprobs, r.logprobs[0],
                               rtol=1e-5, atol=1e-6)
