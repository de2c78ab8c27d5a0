"""Stochastic speculative decoding: the rejection-sampling acceptance rule
must be lossless IN DISTRIBUTION — the emitted-token marginal equals plain
sampling from the target's processed distribution (VERDICT r2 ask #4).

Three tiers:
- pure-math statistical tests of ops/sampling.speculative_accept
  (draft == target => all accepted; per-position acceptance probability
  matches min(1, p/q); emitted marginal matches p);
- processed_probs consistency with sample_tokens (same distribution);
- integration: the sampled round at temperature 0 reproduces the exact
  greedy speculative output; the scheduler accepts sampled submissions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_inference_engine.config import (EngineConfig, SamplingParams,
                                             get_config)
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.ops.sampling import (
    processed_probs, sample_tokens, speculative_accept)
from llm_inference_engine.runtime.engine import InferenceEngine
from llm_inference_engine.runtime.speculative import SpeculativeDecoder

CFG = get_config("debug")


def _dist(rng, V, temp=1.0):
    """A random categorical distribution over V."""
    logits = rng.standard_normal(V) * temp
    e = np.exp(logits - logits.max())
    return e / e.sum()


def test_draft_equals_target_accepts_all():
    """p == q at every position => every draft accepted, any key."""
    rng = np.random.default_rng(0)
    V, B, k = 32, 4, 5
    q = np.stack([[_dist(rng, V) for _ in range(k)] for _ in range(B)])
    p = np.concatenate([q, q[:, -1:]], axis=1)        # [B, k+1, V]
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        kd, ka = jax.random.split(key)
        # drafts sampled from q (per-position categorical)
        draft = np.stack([
            [np.searchsorted(np.cumsum(q[b, j]),
                             rng.uniform()) for j in range(k)]
            for b in range(B)]).astype(np.int32)
        _, n_acc = speculative_accept(jnp.asarray(draft), jnp.asarray(q),
                                      jnp.asarray(p), ka)
        assert (np.asarray(n_acc) == k).all()


def test_acceptance_probability_matches_min_p_over_q():
    """Empirical acceptance of the FIRST draft position ~= E_q[min(1,p/q)]."""
    rng = np.random.default_rng(1)
    V, k, N = 16, 1, 4000
    q0 = _dist(rng, V, temp=2.0)
    p0 = _dist(rng, V, temp=2.0)
    expected = float(np.sum(np.minimum(q0, p0)))      # sum_x q min(1,p/q)

    # N rows in one call: each row draws its own draft from q
    draft = rng.choice(V, size=(N, k), p=q0).astype(np.int32)
    q = jnp.broadcast_to(jnp.asarray(q0, jnp.float32), (N, k, V))
    p = jnp.broadcast_to(jnp.asarray(p0, jnp.float32), (N, k + 1, V))
    _, n_acc = speculative_accept(jnp.asarray(draft), q, p,
                                  jax.random.PRNGKey(7))
    got = float(np.mean(np.asarray(n_acc) == 1))
    assert abs(got - expected) < 0.035, (got, expected)


def test_emitted_marginal_matches_target():
    """The token emitted at position 0 is distributed exactly as p_0 —
    the lossless-in-distribution guarantee (TV distance ~ 0)."""
    rng = np.random.default_rng(2)
    V, k, N = 12, 3, 8000
    q_pos = [_dist(rng, V, temp=1.5) for _ in range(k)]
    p_pos = [_dist(rng, V, temp=1.5) for _ in range(k + 1)]
    q = jnp.broadcast_to(jnp.asarray(np.stack(q_pos), jnp.float32),
                         (N, k, V))
    p = jnp.broadcast_to(jnp.asarray(np.stack(p_pos), jnp.float32),
                         (N, k + 1, V))
    draft = np.stack([rng.choice(V, size=N, p=q_pos[j])
                      for j in range(k)], axis=1).astype(np.int32)
    emitted, n_acc = speculative_accept(jnp.asarray(draft), q, p,
                                        jax.random.PRNGKey(3))
    first = np.asarray(emitted)[:, 0]
    hist = np.bincount(first, minlength=V) / N
    tv = 0.5 * np.abs(hist - p_pos[0]).sum()
    assert tv < 0.04, tv


def test_emitted_marginal_position1_conditional():
    """Position 1's marginal, over rows where position 0 accepted, matches
    p_1 (the chain rule of the lossless proof, tested one level deep)."""
    rng = np.random.default_rng(4)
    V, k, N = 10, 2, 12000
    q_pos = [_dist(rng, V) for _ in range(k)]
    p_pos = [_dist(rng, V) for _ in range(k + 1)]
    q = jnp.broadcast_to(jnp.asarray(np.stack(q_pos), jnp.float32),
                         (N, k, V))
    p = jnp.broadcast_to(jnp.asarray(np.stack(p_pos), jnp.float32),
                         (N, k + 1, V))
    draft = np.stack([rng.choice(V, size=N, p=q_pos[j])
                      for j in range(k)], axis=1).astype(np.int32)
    emitted, n_acc = speculative_accept(jnp.asarray(draft), q, p,
                                        jax.random.PRNGKey(9))
    emitted, n_acc = np.asarray(emitted), np.asarray(n_acc)
    rows = n_acc >= 1                      # position 0 accepted
    second = emitted[rows, 1]
    hist = np.bincount(second, minlength=V) / rows.sum()
    tv = 0.5 * np.abs(hist - p_pos[1]).sum()
    assert tv < 0.04, tv


def test_greedy_onehot_reduces_to_argmax_rule():
    """One-hot p/q (greedy rows from processed_probs) reduce the stochastic
    rule to longest-matching-prefix + target-argmax bonus."""
    V, B, k = 8, 3, 3
    def onehot(ids):
        return jax.nn.one_hot(jnp.asarray(ids), V, dtype=jnp.float32)
    draft = jnp.asarray([[1, 2, 3], [1, 2, 3], [4, 4, 4]], jnp.int32)
    q = onehot(draft)                                   # [B, k, V]
    tgt = jnp.asarray([[1, 2, 3, 5],   # all match -> bonus 5
                       [1, 7, 0, 0],   # mismatch at 1 -> emit [1, 7]
                       [0, 0, 0, 0]])  # mismatch at 0 -> emit [0]
    p = onehot(tgt)                                     # [B, k+1, V]
    emitted, n_acc = speculative_accept(draft, q, p, jax.random.PRNGKey(0))
    assert np.asarray(n_acc).tolist() == [3, 1, 0]
    e = np.asarray(emitted)
    assert e[0].tolist() == [1, 2, 3, 5]
    assert e[1, :2].tolist() == [1, 7]
    assert e[2, 0] == 0


def test_processed_probs_matches_sample_tokens():
    """sample_tokens' empirical distribution equals processed_probs (the
    acceptance rule must score the exact distribution sampling uses)."""
    rng = np.random.default_rng(5)
    V, N = 24, 6000
    logits0 = jnp.asarray(rng.standard_normal(V) * 2, jnp.float32)
    temp = jnp.full((N,), 0.8, jnp.float32)
    topk = jnp.full((N,), 8, jnp.int32)
    topp = jnp.full((N,), 0.9, jnp.float32)
    minp = jnp.full((N,), 0.02, jnp.float32)
    logits = jnp.broadcast_to(logits0, (N, V))
    toks = np.asarray(sample_tokens(logits, jax.random.PRNGKey(11),
                                    temp, topk, topp, minp))
    want = np.asarray(processed_probs(logits0[None], temp[:1], topk[:1],
                                      topp[:1], minp[:1]))[0]
    hist = np.bincount(toks, minlength=V) / N
    tv = 0.5 * np.abs(hist - want).sum()
    assert tv < 0.04, tv
    # greedy: one-hot at argmax
    g = np.asarray(processed_probs(logits0[None],
                                   jnp.zeros((1,), jnp.float32),
                                   topk[:1], topp[:1], minp[:1]))[0]
    assert g[int(np.argmax(np.asarray(logits0)))] == 1.0
    assert g.sum() == 1.0


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------

def _engines(seed_t=0, seed_d=5, B=2):
    eng = EngineConfig(max_batch_size=B, max_seq_len=96)
    target = InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=seed_t,
                                                         scale=0.3))
    draft = InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=seed_d,
                                                        scale=0.3))
    return target, draft


def test_sampled_round_temp0_equals_greedy_round():
    """The stochastic round with temperature 0 must reproduce the greedy
    speculative output exactly (one-hot degenerate case end-to-end)."""
    target, draft = _engines()
    prompts = [[1, 17, 93, 5], [1, 9, 41]]
    spec = SpeculativeDecoder(target, draft, num_draft=3)
    want = spec.generate(prompts, max_new_tokens=12, eos_token_id=None)

    target2, draft2 = _engines()
    spec2 = SpeculativeDecoder(target2, draft2, num_draft=3)
    got = spec2.generate(prompts, max_new_tokens=12, eos_token_id=None,
                         sampling=SamplingParams(temperature=0.0,
                                                 max_new_tokens=12))
    assert got.token_ids == want.token_ids


def test_sampled_spec_identical_models_accept_all():
    """draft == target (same processed dists) => every draft accepted."""
    target, draft = _engines(seed_t=0, seed_d=0)
    spec = SpeculativeDecoder(target, draft, num_draft=3)
    res = spec.generate([[1, 4, 9], [1, 2, 3]], max_new_tokens=16,
                        eos_token_id=None,
                        sampling=SamplingParams(temperature=0.9, top_k=20,
                                                max_new_tokens=16))
    assert res.num_drafted > 0
    assert res.num_accepted == res.num_drafted


def _ref_frozen_greedy(params, prompts, k, total, sp, B, seq=96):
    """Reference for the frozen-counts penalty semantics: sequential
    greedy decode where the penalty counts refresh only at speculative
    round boundaries (after the prefill token, then every k+1 tokens) —
    exactly what a full-acceptance draft==target round produces."""
    import dataclasses
    from llm_inference_engine.models import llama as M
    from llm_inference_engine.ops import kv_cache as kvc
    from llm_inference_engine.ops.sampling import apply_penalties

    eng = EngineConfig(max_batch_size=B, max_seq_len=seq)
    V = CFG.vocab_size
    T = max(len(p) for p in prompts)
    ids = np.zeros((B, T), np.int32)
    lens = np.zeros((B,), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
        lens[i] = len(p)
    cache = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads, seq,
                             CFG.head_dim, dtype=CFG.dtype)
    logits, cache = M.forward_hidden(CFG, eng, params, jnp.asarray(ids),
                                     cache, jnp.zeros((B,), jnp.int32),
                                     jnp.asarray(lens))
    cache = dataclasses.replace(cache, lengths=jnp.asarray(lens))

    cc = np.zeros((B, V), np.int32)
    cg = np.zeros((B, V), np.int32)
    for i, p in enumerate(prompts):
        np.add.at(cc[i], np.asarray(p, np.int64), 1)
    rep = jnp.full((B,), sp.repetition_penalty, jnp.float32)
    pres = jnp.full((B,), sp.presence_penalty, jnp.float32)
    freq = jnp.full((B,), sp.frequency_penalty, jnp.float32)

    def pick(lg, fc, fg):
        pl = apply_penalties(lg, jnp.asarray(fc), jnp.asarray(fg),
                             rep, pres, freq)
        return np.asarray(jnp.argmax(pl, -1).astype(jnp.int32))

    last = pick(logits, cc, cg)                       # prefill token
    np.add.at(cc, (np.arange(B), last), 1)
    np.add.at(cg, (np.arange(B), last), 1)
    out = [[int(last[i])] for i in range(B)]
    frozen_c, frozen_g = cc.copy(), cg.copy()         # round 1 snapshot
    for step in range(total - 1):
        if step % (k + 1) == 0:
            frozen_c, frozen_g = cc.copy(), cg.copy()
        ln = cache.lengths
        logits, cache = M.forward_hidden(CFG, eng, params,
                                         jnp.asarray(last)[:, None], cache,
                                         ln, ln + 1)
        cache = dataclasses.replace(cache, lengths=ln + 1)
        last = pick(logits, frozen_c, frozen_g)
        np.add.at(cc, (np.arange(B), last), 1)
        np.add.at(cg, (np.arange(B), last), 1)
        for i in range(B):
            out[i].append(int(last[i]))
    return out


def test_spec_penalties_frozen_semantics_greedy():
    """VERDICT r3 #8: penalties with counts frozen at round start. With
    draft == target every greedy round fully accepts (both argmax chains
    run under the SAME frozen counts), so the emitted stream must equal
    a sequential greedy decode whose counts refresh every k+1 tokens."""
    k, total = 3, 12
    sp = SamplingParams(greedy=True, repetition_penalty=1.4,
                        presence_penalty=0.3, frequency_penalty=0.2,
                        max_new_tokens=total)
    params = init_dummy_params(CFG, seed=0, scale=0.3)
    prompts = [[1, 17, 93, 5], [1, 9, 41]]
    want = _ref_frozen_greedy(params, prompts, k, total, sp, B=2)

    eng = EngineConfig(max_batch_size=2, max_seq_len=96)
    target = InferenceEngine(CFG, eng, params)
    draft = InferenceEngine(CFG, eng, params)      # same model
    spec = SpeculativeDecoder(target, draft, num_draft=k)
    got = spec.generate(prompts, max_new_tokens=total, eos_token_id=None,
                        sampling=sp)
    assert got.token_ids == want
    assert got.num_accepted == got.num_drafted     # full acceptance


def test_spec_penalties_effective_and_lossless_shape():
    """A near-uniform model (tiny weight scale) repeats itself under
    neutral greedy decoding; a strong presence penalty through the
    speculative rounds must forbid every repeat. Then a penalized sampled
    round must run end-to-end with in-vocab output."""
    params = init_dummy_params(CFG, seed=0, scale=0.02)
    eng = EngineConfig(max_batch_size=1, max_seq_len=96)

    def gen(sp):
        t = InferenceEngine(CFG, eng, params)
        d = InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=5,
                                                        scale=0.02))
        return SpeculativeDecoder(t, d, num_draft=2).generate(
            [[1, 2, 3]], max_new_tokens=14, eos_token_id=None, sampling=sp)

    neutral = gen(SamplingParams(greedy=True, max_new_tokens=14))
    assert len(set(neutral.token_ids[0])) < 14      # it does repeat
    pen = gen(SamplingParams(greedy=True, presence_penalty=50.0,
                             max_new_tokens=14))
    assert len(set(pen.token_ids[0])) == 14         # penalty forbids it
    # penalized sampled round: runs end-to-end, in-vocab output
    samp = gen(SamplingParams(temperature=0.8, top_k=16,
                              repetition_penalty=1.3, presence_penalty=0.4))
    assert len(samp.token_ids[0]) == 14
    assert all(0 <= t < CFG.vocab_size for t in samp.token_ids[0])


def test_scheduler_accepts_sampled_requests():
    """The server path: sampled submissions run (mixed with greedy) and
    produce tokens; greedy requests still match the plain engine."""
    from llm_inference_engine.runtime.speculative_scheduler import (
        SpeculativeScheduler)
    target, draft = _engines(B=3)
    plain = InferenceEngine(CFG, EngineConfig(max_batch_size=3,
                                              max_seq_len=96),
                            init_dummy_params(CFG, seed=0, scale=0.3))
    want = plain.generate([[1, 17, 93, 5]],
                          SamplingParams(greedy=True, max_new_tokens=10),
                          eos_token_id=None).token_ids[0]

    sched = SpeculativeScheduler(target, draft, eos_token_id=None,
                                 num_draft=3)
    r_greedy = sched.submit([1, 17, 93, 5],
                            SamplingParams(greedy=True, max_new_tokens=10))
    r_samp = sched.submit([1, 9, 41],
                          SamplingParams(temperature=0.8, top_k=16,
                                         max_new_tokens=10))
    r_samp2 = sched.submit([1, 5],
                           SamplingParams(temperature=1.1, top_p=0.9,
                                          max_new_tokens=8))
    sched.run()
    assert r_greedy.output_ids == want
    assert len(r_samp.output_ids) == 10
    assert len(r_samp2.output_ids) == 8
    assert all(0 <= t < CFG.vocab_size for t in r_samp.output_ids)
    # penalized submissions run too (frozen-counts round semantics)
    r_pen = sched.submit([1], SamplingParams(temperature=0.7,
                                             presence_penalty=0.5,
                                             max_new_tokens=6))
    sched.run()
    assert r_pen.finished and len(r_pen.output_ids) == 6
