"""Paged KV cache tests (ops/paged_kv.py).

Goldens: a dense slot cache scattered into randomized page assignments.
The scatter write and the table-indirected attention are compared against
the same dense reference.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from llm_inference_engine.ops.attention import attention, attention_ref
from llm_inference_engine.ops import paged_kv as PK

L, PAGE, K, D = 2, 16, 8, 128
B, MAXP = 3, 4
S = MAXP * PAGE       # 64 logical tokens per slot


def _mk_cache(rng, quantized=False):
    """Pool + a shuffled (non-identity) table covering every slot."""
    num_pages = 1 + B * MAXP + 2
    cache = PK.new_paged_kv_cache(L, B, K, num_pages, PAGE, D, MAXP,
                                  dtype=jnp.float32, quantized=quantized)
    perm = rng.permutation(np.arange(1, 1 + B * MAXP)).reshape(B, MAXP)
    cache = PK.PagedKVCache(
        k=cache.k, v=cache.v, block_table=jnp.asarray(perm, jnp.int32),
        lengths=cache.lengths, embedded_scales=cache.embedded_scales)
    return cache


def _dense_of(cache):
    """[B, S, Kst, D] dense views via the golden gather."""
    outs = []
    for l in range(L):
        outs.append(PK.gather_layer_pages(cache, jnp.int32(l)))
    kd = jnp.stack([o[0] for o in outs])
    vd = jnp.stack([o[1] for o in outs])
    return kd, vd   # [L, B, S, Kst, D]


def test_paged_write_matches_dense(rng):
    cache = _mk_cache(rng)
    # dense reference cache
    ref_k = np.zeros((L, B, S, K, D), np.float32)
    ref_v = np.zeros((L, B, S, K, D), np.float32)

    writes = [
        # (starts, nlen, T) — C-aligned chunk rows (C=8, page=16: offsets 0
        # and 8 within a page) + single-token rows at arbitrary offsets
        (np.array([0, 16, 0], np.int32), np.array([8, 8, 0], np.int32), 8),
        (np.array([8, 24, 0], np.int32), np.array([8, 8, 8], np.int32), 8),
        (np.array([16, 32, 8], np.int32), np.array([1, 1, 3], np.int32), 8),
        (np.array([17, 33, 11], np.int32), np.array([1, 1, 1], np.int32), 1),
    ]
    for step, (starts, nlen, T) in enumerate(writes):
        for l in range(L):
            nk = rng.standard_normal((B, T, K, D)).astype(np.float32)
            nv = rng.standard_normal((B, T, K, D)).astype(np.float32)
            cache = PK.paged_update_at_layer(
                cache, jnp.int32(l), jnp.asarray(nk), jnp.asarray(nv),
                jnp.asarray(starts), jnp.asarray(nlen))
            for b in range(B):
                n = int(nlen[b])
                s0 = int(starts[b])
                ref_k[l, b, s0:s0 + n] = nk[b, :n]
                ref_v[l, b, s0:s0 + n] = nv[b, :n]

    kd, vd = _dense_of(cache)
    lengths = np.array([18, 34, 12])
    for b in range(B):
        n = lengths[b]
        np.testing.assert_allclose(np.asarray(kd)[:, b, :n], ref_k[:, b, :n],
                                   err_msg=f"k b={b}")
        np.testing.assert_allclose(np.asarray(vd)[:, b, :n], ref_v[:, b, :n])


def _fill_cache(rng, cache, lengths):
    """Scatter random dense content into the pool; returns dense arrays."""
    dense_k = rng.standard_normal((L, B, S, K, D)).astype(np.float32)
    dense_v = rng.standard_normal((L, B, S, K, D)).astype(np.float32)
    k = np.zeros(cache.k.shape, np.float32)
    v = np.zeros(cache.v.shape, np.float32)
    table = np.asarray(cache.block_table)
    for b in range(B):
        for j in range(MAXP):
            p = table[b, j]
            k[:, p] = dense_k[:, b, j * PAGE:(j + 1) * PAGE]
            v[:, p] = dense_v[:, b, j * PAGE:(j + 1) * PAGE]
    cache = PK.PagedKVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), block_table=cache.block_table,
        lengths=jnp.asarray(lengths, jnp.int32),
        embedded_scales=cache.embedded_scales)
    return cache, dense_k, dense_v


def test_paged_prefill_attention_matches_dense(rng):
    cache = _mk_cache(rng)
    lengths = np.array([40, 64, 9], np.int32)
    cache, dense_k, dense_v = _fill_cache(rng, cache, lengths)
    Sq, H = 8, 16                   # GQA group 2
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    q_start = jnp.asarray(lengths - Sq)
    kv_len = jnp.asarray(lengths)

    for l in range(L):
        got = attention(jnp.asarray(q), cache.k, cache.v, q_start, kv_len,
                        layer=jnp.int32(l), table=cache.block_table)
        want = attention_ref(jnp.asarray(q), jnp.asarray(dense_k[l]),
                             jnp.asarray(dense_v[l]), q_start, kv_len)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-5, err_msg=f"l={l}")


def test_paged_decode_matches_dense(rng):
    cache = _mk_cache(rng)
    lengths = np.array([33, 64, 1], np.int32)
    cache, dense_k, dense_v = _fill_cache(rng, cache, lengths)
    H = 16
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kv_len = jnp.asarray(lengths)
    q_start = kv_len - 1

    for l in range(L):
        got = attention(jnp.asarray(q), cache.k, cache.v, q_start, kv_len,
                        layer=jnp.int32(l), table=cache.block_table,
                        kv_hi=S)
        want = attention_ref(jnp.asarray(q), jnp.asarray(dense_k[l]),
                             jnp.asarray(dense_v[l]), q_start, kv_len)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-5, err_msg=f"l={l}")


def test_paged_xla_fallback_matches_dense(rng):
    cache = _mk_cache(rng)
    lengths = np.array([20, 50, 3], np.int32)
    cache, dense_k, dense_v = _fill_cache(rng, cache, lengths)
    q = rng.standard_normal((B, 4, K, D)).astype(np.float32)
    q_start = jnp.asarray(lengths - 4)
    kv_len = jnp.asarray(lengths)
    got = attention(jnp.asarray(q), cache.k, cache.v, q_start, kv_len, layer=jnp.int32(1),
                    table=cache.block_table)
    want = attention_ref(jnp.asarray(q), jnp.asarray(dense_k[1]),
                         jnp.asarray(dense_v[1]), q_start, kv_len)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_allocator():
    a = PK.PageAllocator(8)         # page 0 reserved -> 7 usable
    assert a.free_pages == 7
    got = a.alloc(3)
    assert len(set(got)) == 3 and 0 not in got
    a.free(got[:2])
    assert a.free_pages == 6
    with pytest.raises(MemoryError):
        a.alloc(7)
    with pytest.raises(ValueError):
        a.free([0])


# ---------------------------------------------------------------------------
# engine-level parity: paged engine == slot engine, token for token
# ---------------------------------------------------------------------------

def _engine(layout, **kw):
    from llm_inference_engine.config import EngineConfig, get_config
    from llm_inference_engine.models.weights import init_dummy_params
    from llm_inference_engine.runtime.engine import InferenceEngine
    cfg = get_config("debug")
    eng = EngineConfig(max_batch_size=2, max_seq_len=64,
                       max_prefill_len=8, kv_layout=layout, page_size=16,
                       **kw)
    return InferenceEngine(cfg, eng, init_dummy_params(cfg, seed=0))


def test_paged_engine_generate_matches_slot():
    from llm_inference_engine.config import SamplingParams
    sp = SamplingParams(greedy=True, max_new_tokens=10)
    prompts = [list(range(1, 20)), [9, 8, 7]]     # chunked (C=8) + short
    slot = _engine("slot").generate(prompts, sp, eos_token_id=None)
    paged_eng = _engine("paged")
    paged = paged_eng.generate(prompts, sp, eos_token_id=None)
    assert paged.token_ids == slot.token_ids
    # pages were actually allocated page-by-page (19+10=29 -> 2 pages,
    # 3+10=13 -> 1 page)
    assert [len(p) for p in paged_eng._slot_pages] == [2, 1]
    # reset releases every page back to the pool
    free0 = paged_eng._allocator.num_pages - 1
    paged_eng.reset()
    assert paged_eng.free_pages == free0


def test_paged_engine_streaming_decode_matches_slot():
    from llm_inference_engine.config import SamplingParams
    sp = SamplingParams(greedy=True, max_new_tokens=8)
    cb_tokens = []
    slot = _engine("slot").generate(
        [[1, 2, 3]], sp, eos_token_id=None,
        stream_callback=lambda i, t: None)
    paged = _engine("paged").generate(
        [[1, 2, 3]], sp, eos_token_id=None,
        stream_callback=lambda i, t: cb_tokens.append(t))
    assert paged.token_ids == slot.token_ids
    assert cb_tokens == paged.token_ids[0]


def test_paged_pool_exhaustion_raises():
    eng = _engine("paged", num_pages=3)          # page 0 reserved -> 2 usable
    from llm_inference_engine.config import SamplingParams
    with pytest.raises(MemoryError):
        eng.generate([list(range(1, 40))],       # 39 tokens -> 3+ pages
                     SamplingParams(greedy=True, max_new_tokens=4),
                     eos_token_id=None)


# ---------------------------------------------------------------------------
# scheduler-level: paged serving parity, admission gating, preemption
# ---------------------------------------------------------------------------

def _sched(layout, **kw):
    from llm_inference_engine.runtime.scheduler import (
        ContinuousBatchingScheduler)
    return ContinuousBatchingScheduler(_engine(layout, **kw),
                                       eos_token_id=None)


def test_paged_scheduler_matches_slot_under_load():
    from llm_inference_engine.config import SamplingParams
    sp = SamplingParams(greedy=True, max_new_tokens=7)
    prompts = [[1 + i, 2 + i, 3 + i, 4 + i] for i in range(5)] \
        + [list(range(10, 30))]                   # + one chunked prompt
    slot = _sched("slot")
    rs = [slot.submit(p, sp) for p in prompts]
    slot.run()
    paged = _sched("paged")
    rp = [paged.submit(p, sp) for p in prompts]
    paged.run()
    assert [r.output_ids for r in rp] == [r.output_ids for r in rs]
    # every page returned to the pool once all requests finished
    assert paged.engine.free_pages == paged.engine._allocator.num_pages - 1


def test_paged_preemption_recompute_parity():
    """A pool too small for both requests' full lengths forces recompute
    preemption; outputs still match the slot engine exactly and the
    preempted request reports it."""
    from llm_inference_engine.config import SamplingParams
    sp = SamplingParams(greedy=True, max_new_tokens=20)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]]

    slot = _sched("slot")
    rs = [slot.submit(p, sp) for p in prompts]
    slot.run()

    # each request needs ceil((8+20+1)/16)=2 pages eventually; 3 usable
    # pages cannot host both -> the newer request gets preempted
    paged = _sched("paged", num_pages=4)
    rp = [paged.submit(p, sp) for p in prompts]
    paged.run(max_steps=500)
    assert [r.output_ids for r in rp] == [r.output_ids for r in rs]
    assert rp[1].preemptions > 0
    assert rp[0].preemptions == 0
    assert paged.engine.free_pages == 3


def test_paged_admission_waits_for_pages():
    from llm_inference_engine.config import SamplingParams
    sp = SamplingParams(greedy=True, max_new_tokens=4)
    paged = _sched("paged", num_pages=3)          # 2 usable pages
    a = paged.submit(list(range(1, 17)), sp)      # 16 tokens -> 2 pages
    b = paged.submit(list(range(1, 17)), sp)      # must wait for a's pages
    paged.step()
    assert a.slot >= 0 and b.slot == -1           # b gated at admission
    paged.run(max_steps=500)
    assert a.finished and b.finished
    assert len(a.output_ids) == 4 and a.output_ids == b.output_ids


def test_paged_single_oversized_request_finishes_capacity():
    from llm_inference_engine.config import SamplingParams
    paged = _sched("paged", num_pages=2)          # 1 usable page (16 tok)
    r = paged.submit([1, 2, 3],
                     SamplingParams(greedy=True, max_new_tokens=40))
    paged.run(max_steps=500)
    assert r.finished and r.finish_reason == "capacity"
    assert len(r.output_ids) <= 13


def test_paged_embedded_int8_write_and_attend(rng):
    """Quantized paged pool (embedded scale rows): write through the
    packing path, attend via the table-indirected XLA golden, compare to
    dequantized dense attention within int8 tolerance."""
    cache = PK.new_paged_kv_cache(1, 2, K, 1 + 2 * MAXP, PAGE, D, MAXP,
                                  quantized=True)
    table = np.arange(1, 1 + 2 * MAXP, dtype=np.int32).reshape(2, MAXP)
    cache = PK.PagedKVCache(k=cache.k, v=cache.v,
                            block_table=jnp.asarray(table),
                            lengths=cache.lengths, embedded_scales=True)
    n = 24
    nk = rng.standard_normal((2, PAGE, K, D)).astype(np.float32)
    nv = rng.standard_normal((2, PAGE, K, D)).astype(np.float32)
    for off in (0, PAGE):
        cache = PK.paged_update_at_layer(
            cache, jnp.int32(0), jnp.asarray(nk), jnp.asarray(nv),
            jnp.asarray([off, off], jnp.int32),
            jnp.asarray([PAGE, min(PAGE, n)], jnp.int32))

    q = rng.standard_normal((2, 1, K, D)).astype(np.float32)
    kv_len = jnp.asarray([2 * PAGE, n], jnp.int32)
    got = attention(jnp.asarray(q), cache.k, cache.v, kv_len - 1, kv_len, layer=jnp.int32(0),
                    table=cache.block_table, embedded_kv=True)
    dense_k = np.concatenate([nk, nk], axis=1)[:, :2 * PAGE]
    dense_v = np.concatenate([nv, nv], axis=1)
    want = attention_ref(jnp.asarray(q), jnp.asarray(dense_k),
                         jnp.asarray(dense_v), kv_len - 1, kv_len)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0.05, atol=0.05)


def test_paged_int8_kv_engine_generates():
    """End-to-end paged + embedded-int8 KV engine smoke (vocab-sane greedy
    output, page accounting)."""
    from llm_inference_engine.config import SamplingParams
    eng = _engine("paged", kv_cache_dtype_name="int8")
    r = eng.generate([[1, 2, 3, 4, 5]],
                     SamplingParams(greedy=True, max_new_tokens=6),
                     eos_token_id=None)
    assert len(r.token_ids[0]) == 6
    assert all(0 <= t < eng.config.vocab_size for t in r.token_ids[0])


def test_paged_multi_round_append_rejected():
    from llm_inference_engine.config import SamplingParams
    eng = _engine("paged")
    eng.generate([[1, 2, 3]], SamplingParams(greedy=True, max_new_tokens=2),
                 eos_token_id=None)
    with pytest.raises(ValueError, match="multiple of max_prefill_len"):
        eng.prefill([list(range(1, 12))], slots=[0])   # mid-page append


def test_paged_router_and_chat_session():
    """DP-router serving over paged per-host schedulers, and multi-round
    chat on a paged engine (full-context re-prefill each round matches the
    slot engine's KV-append rounds token for token)."""
    from llm_inference_engine.cli import _IdTokenizer
    from llm_inference_engine.config import SamplingParams
    from llm_inference_engine.runtime.multihost_scheduler import (
        RequestRouter)
    from llm_inference_engine.runtime.scheduler import (
        ContinuousBatchingScheduler)
    from llm_inference_engine.runtime.session import ChatSession

    sp = SamplingParams(greedy=True, max_new_tokens=5)
    router = RequestRouter([
        ContinuousBatchingScheduler(_engine("paged"), eos_token_id=None)
        for _ in range(2)])
    reqs = [router.submit([3 + i, 5, 7], sp) for i in range(5)]
    router.run()
    assert all(len(r.output_ids) == 5 for r in reqs)

    tok = _IdTokenizer(256)
    answers = {}
    for layout in ("slot", "paged"):
        s = ChatSession(_engine(layout), tok)
        a1 = s.response("5 9", SamplingParams(greedy=True,
                                              max_new_tokens=4))
        a2 = s.response("11 13", SamplingParams(greedy=True,
                                                max_new_tokens=4))
        answers[layout] = (a1, a2)
    assert answers["paged"] == answers["slot"]


def test_paged_oversized_prompt_rejected_no_starvation():
    """A prompt that can never fit the pool is rejected at submit instead
    of head-of-line blocking the queue forever (review finding)."""
    from llm_inference_engine.config import SamplingParams
    sched = _sched("paged", num_pages=4)          # 3 pages = 48 tokens
    sp = SamplingParams(greedy=True, max_new_tokens=3)
    big = sched.submit(list(range(1, 50)), sp)    # 49 tokens -> 4 pages
    small = sched.submit([1, 2, 3], sp)
    assert big.finished and big.finish_reason == "rejected"
    sched.run(max_steps=200)
    assert small.finished and len(small.output_ids) == 3


def test_preemption_preserves_generation_counts():
    """Recompute preemption must not reset the presence/frequency penalty
    state: a preempted run equals an unconstrained run with the same
    penalties (review finding)."""
    from llm_inference_engine.config import SamplingParams
    sp = SamplingParams(greedy=True, max_new_tokens=20,
                        frequency_penalty=0.7, presence_penalty=0.3,
                        repetition_penalty=1.2)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]]
    slot = _sched("slot")
    rs = [slot.submit(p, sp) for p in prompts]
    slot.run()
    paged = _sched("paged", num_pages=4)
    rp = [paged.submit(p, sp) for p in prompts]
    paged.run(max_steps=500)
    assert rp[1].preemptions > 0          # the scenario actually preempts
    assert [r.output_ids for r in rp] == [r.output_ids for r in rs]


def test_paged_separate_scale_attention_rejected(rng):
    cache = _mk_cache(rng)
    q = jnp.asarray(rng.standard_normal((B, 4, K, D)), jnp.float32)
    kl = jnp.asarray([8, 8, 8], jnp.int32)
    sc = jnp.ones((L, cache.num_pages, PAGE, K), jnp.float32)
    with pytest.raises(NotImplementedError, match="embedded"):
        attention(q, cache.k, cache.v, kl - 4, kl, k_scale=sc, v_scale=sc,
                  layer=jnp.int32(0), table=cache.block_table)


def test_paged_session_carries_pages_across_rounds():
    """Multi-round paged chat must NOT re-prefill the whole history: full
    pages carry across the slot reset via refcounted shares
    (session._paged_carry_history), only the partial tail page + the new
    turn re-prefill — and the answers still match the slot layout
    (VERDICT r2 ask #6)."""
    from llm_inference_engine.cli import _IdTokenizer
    from llm_inference_engine.config import SamplingParams
    from llm_inference_engine.runtime.session import ChatSession

    tok = _IdTokenizer(256)
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    # long turns so history exceeds one 16-token page by round 2
    turns = [" ".join(str(3 + i) for i in range(12)),
             " ".join(str(40 + i) for i in range(10)),
             "9 9 9"]

    answers = {}
    prefilled = {}
    for layout in ("slot", "paged"):
        eng = _engine(layout)
        # count the tokens fed through prefill each round
        counts = []
        orig = eng.prefill
        def spy(prompts, *a, **kw):
            counts.append(sum(len(p) for p in prompts))
            return orig(prompts, *a, **kw)
        eng.prefill = spy
        s = ChatSession(eng, tok)
        answers[layout] = [s.response(t, sp) for t in turns]
        prefilled[layout] = counts
        if layout == "paged":
            hist_len = len(s.token_history)
    assert answers["paged"] == answers["slot"]
    # the paged session's later rounds prefill only tail + new turn:
    # strictly less than the full history each round (minus the engine's
    # internal 1-token top-up prefills, which both layouts share)
    slot_counts, paged_counts = prefilled["slot"], prefilled["paged"]
    assert paged_counts[0] == slot_counts[0]          # round 1 identical
    # round 2+: paged prefills less than history+turn would cost
    big_paged = [c for c in paged_counts[1:] if c > 1]
    big_slot = [c for c in slot_counts[1:] if c > 1]
    assert len(big_paged) == len(big_slot)
    for p_c, s_c in zip(big_paged, big_slot):
        # slot appends exactly the turn; paged adds the sub-page tail,
        # bounded by one page (16) — never the whole history
        assert p_c < s_c + 16
    assert hist_len > 32                              # crossed 2+ pages
