"""Prefix caching tests (runtime/prefix_cache.py).

No reference counterpart (the reference recomputes the whole accumulated
history each round, llama.cpp:137-155). Invariants: restoring a snapshot
and prefilling only the tail is indistinguishable from prefilling the full
prompt — logits, greedy tokens, every cache variant — and the store's
match/LRU semantics hold.
"""

import numpy as np
import pytest

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.engine import InferenceEngine
from llm_inference_engine.runtime.prefix_cache import PrefixStore
from llm_inference_engine.runtime.scheduler import ContinuousBatchingScheduler

CFG = get_config("debug")
PREFIX = list(range(5, 21))          # 16 tokens == one chunk at C=16
TAILS = [[40, 41], [50, 51, 52, 53], [60]]


def make_engine(batch=2, seq=96, **kw):
    eng = EngineConfig(max_batch_size=batch, max_seq_len=seq,
                       max_prefill_len=16, **kw)
    return InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=0))


def test_restore_then_tail_matches_full_prefill():
    """prefix-restore + tail prefill == full prefill, bit-for-bit (the
    chunk boundaries coincide when the prefix is chunk-aligned)."""
    full = make_engine()
    logits_full = np.asarray(full.prefill([PREFIX + TAILS[0]], slots=[0]))

    eng = make_engine()
    store = PrefixStore(eng)
    entry = store.register(PREFIX, slot=1)
    assert entry.length == len(PREFIX)
    assert int(np.asarray(eng.cache.lengths)[1]) == 0   # scratch slot reset

    store.restore(0, entry)
    assert int(np.asarray(eng.cache.lengths)[0]) == len(PREFIX)
    logits_reused = np.asarray(eng.prefill([TAILS[0]], slots=[0]))

    np.testing.assert_array_equal(logits_full[0], logits_reused[0])


def test_restore_into_any_slot():
    """One compiled restore serves every slot (slot index is traced)."""
    eng = make_engine(batch=3)
    store = PrefixStore(eng)
    entry = store.register(PREFIX, slot=0)
    for slot in (2, 1, 0):
        store.restore(slot, entry)
        assert int(np.asarray(eng.cache.lengths)[slot]) == len(PREFIX)


def test_match_longest_strict_and_lru_eviction():
    eng = make_engine()
    store = PrefixStore(eng, max_tokens=192)   # room for 3 padded-64 entries
    short = PREFIX[:8]
    store.register(short, slot=0)
    long_e = store.register(PREFIX, slot=0)

    # longest strict prefix wins
    assert store.match(PREFIX + [99]) is long_e
    # a prompt equal to the prefix must NOT match (no tail to sample from)
    assert store.match(PREFIX) is not None      # the SHORT entry matches
    assert store.match(PREFIX).length == len(short)
    assert store.match([1, 2, 3]) is None

    # LRU: registering past the budget evicts the least-recently matched
    store.match(list(short) + [7])              # refresh `short`
    store.register([70, 71, 72], slot=0)
    store.register([80, 81, 82], slot=0)        # budget forces an eviction
    # the 16-token entry (least-recently matched) went; `short` still hits
    assert store.match(PREFIX + [99]).length == len(short)
    assert store.match(list(short) + [7]) is not None

    with pytest.raises(ValueError):
        store.register([], slot=0)
    with pytest.raises(ValueError):
        store.register(list(range(200)), slot=0)  # >= max_seq_len


def _run_sched(prompts, sp, prefix=None, **eng_kw):
    eng = make_engine(**eng_kw)
    sched = ContinuousBatchingScheduler(eng, eos_token_id=None)
    if prefix is not None:
        sched.register_prefix(prefix)
    reqs = [sched.submit(p, sp) for p in prompts]
    sched.run()
    return reqs


def test_scheduler_prefix_reuse_token_parity():
    """Requests sharing a registered prefix produce exactly the tokens of
    a prefix-less run, skip the prefix's prefill, and non-matching
    requests are untouched."""
    prompts = [PREFIX + t for t in TAILS] + [[3, 1, 4, 1, 5]]
    sp = SamplingParams(greedy=True, max_new_tokens=6)

    base = _run_sched(prompts, sp)
    reused = _run_sched(prompts, sp, prefix=PREFIX)

    assert [r.output_ids for r in reused] == [r.output_ids for r in base]
    assert [r.reused_prefix_len for r in reused] == [16, 16, 16, 0]
    assert all(r.reused_prefix_len == 0 for r in base)


def test_scheduler_prefix_reuse_int8_kv_cache():
    """Storage-form snapshot restore is exact for the int8 KV cache too."""
    prompts = [PREFIX + t for t in TAILS[:2]]
    sp = SamplingParams(greedy=True, max_new_tokens=5)
    kw = dict(kv_cache_dtype_name="int8")
    base = _run_sched(prompts, sp, **kw)
    reused = _run_sched(prompts, sp, prefix=PREFIX, **kw)
    assert [r.output_ids for r in reused] == [r.output_ids for r in base]
    assert all(r.reused_prefix_len == 16 for r in reused)


def test_unaligned_prefix_token_parity():
    """A prefix that is NOT a multiple of the chunk size still reuses
    correctly (greedy tokens match the recomputed run)."""
    prefix = list(range(5, 24))                 # 19 tokens, C=16
    prompts = [prefix + [40, 41, 42]]
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    base = _run_sched(prompts, sp)
    reused = _run_sched(prompts, sp, prefix=prefix)
    assert reused[0].output_ids == base[0].output_ids
    assert reused[0].reused_prefix_len == 19


def test_prefix_reuse_preserves_repetition_penalty():
    """Restored prefix tokens must still count as context for the
    repetition penalty: outputs match the no-reuse run exactly
    (review finding: restore copied KV but not the count planes)."""
    sp = SamplingParams(greedy=True, max_new_tokens=8,
                        repetition_penalty=1.5)
    prompts = [PREFIX + t for t in TAILS[:2]]
    base = _run_sched(prompts, sp)
    reused = _run_sched(prompts, sp, prefix=PREFIX)
    assert all(r.reused_prefix_len == len(PREFIX) for r in reused)
    assert [r.output_ids for r in reused] == [r.output_ids for r in base]


# ---------------------------------------------------------------------------
# zero-copy paged prefix caching (PagedPrefixStore)
# ---------------------------------------------------------------------------

def _paged_engine(**kw):
    eng = EngineConfig(max_batch_size=2, max_seq_len=96,
                       max_prefill_len=16, kv_layout="paged", page_size=16,
                       **kw)
    return InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=0))


def _run_paged_sched(prompts, sp, prefix=None, **kw):
    sched = ContinuousBatchingScheduler(_paged_engine(**kw),
                                        eos_token_id=None)
    if prefix is not None:
        sched.register_prefix(prefix)
    reqs = [sched.submit(p, sp) for p in prompts]
    sched.run(max_steps=1000)
    return sched, reqs


def test_paged_prefix_token_parity_with_penalties():
    """Zero-copy shared pages reproduce the no-reuse run exactly — greedy
    AND with repetition penalty (ctx counts seeded from shared tokens)."""
    prefix = list(range(5, 5 + 32))            # 2 full pages at page=16
    prompts = [prefix + [40, 41], prefix + [50]]
    for sp in (SamplingParams(greedy=True, max_new_tokens=6),
               SamplingParams(greedy=True, max_new_tokens=6,
                              repetition_penalty=1.5)):
        _, base = _run_paged_sched(prompts, sp)
        sched, reused = _run_paged_sched(prompts, sp, prefix=prefix)
        assert all(r.reused_prefix_len == 32 for r in reused)
        assert ([r.output_ids for r in reused]
                == [r.output_ids for r in base])
        # all request pages returned; the 2 shared pages stay with the
        # store (refcounted)
        alloc = sched.engine._allocator
        assert sched.engine.free_pages == alloc.num_pages - 1 - 2


def test_paged_prefix_is_zero_copy_shared():
    """Two concurrent requests over a 2-page prefix consume shared pages
    ONCE: the pool dips by 2 shared + per-request tails only."""
    prefix = list(range(5, 5 + 32))
    sched = ContinuousBatchingScheduler(_paged_engine(), eos_token_id=None)
    sched.register_prefix(prefix)
    total = sched.engine._allocator.num_pages - 1
    assert sched.engine.free_pages == total - 2      # store holds 2 pages

    sp = SamplingParams(greedy=True, max_new_tokens=4)
    a = sched.submit(prefix + [40, 41], sp)
    b = sched.submit(prefix + [50, 51], sp)
    sched.step()                                     # both admitted
    assert a.reused_prefix_len == 32 and b.reused_prefix_len == 32
    # in flight: 2 shared pages (refcounted, counted once) + 1 own tail
    # page per request = 4 pages out, NOT 2 * 3 = 6
    assert sched.engine.free_pages == total - 4
    sched.run(max_steps=1000)
    assert sched.engine.free_pages == total - 2      # only the store holds


def test_paged_prefix_eviction_while_in_use():
    """Evicting an entry while a request still references its pages only
    drops the store's reference; the pages free when the request ends."""
    prefix = list(range(5, 5 + 16))                  # 1 page
    sched = ContinuousBatchingScheduler(_paged_engine(), eos_token_id=None)
    sched.register_prefix(prefix)
    total = sched.engine._allocator.num_pages - 1
    sp = SamplingParams(greedy=True, max_new_tokens=8)
    r = sched.submit(prefix + [40, 41], sp)
    sched.step()
    assert r.reused_prefix_len == 16
    assert sched.prefix_store.evict(prefix)
    assert sched.engine.free_pages < total           # request still holds
    sched.run(max_steps=1000)
    assert r.finished and len(r.output_ids) == 8
    assert sched.engine.free_pages == total          # everything returned


def test_paged_prefix_register_validations():
    from llm_inference_engine.runtime.prefix_cache import (
        PagedPrefixStore)
    eng = _paged_engine()
    store = PagedPrefixStore(eng, max_tokens=64)
    with pytest.raises(ValueError, match="shorter than one page"):
        store.register(list(range(5)), slot=0)
    # partial tail page is NOT shared: a 20-token prefix shares 16
    e = store.register(list(range(3, 23)), slot=0)
    assert e.length == 16 and len(e.pages) == 1
    # LRU eviction frees pages back to the pool
    total = eng._allocator.num_pages - 1
    store.register(list(range(40, 88)), slot=0)      # 48 tok -> 3 pages
    store.register(list(range(100, 132)), slot=0)    # 32 tok -> evicts
    assert store.stored_tokens <= 64
    assert eng.free_pages == total - store.stored_tokens // 16


# ---------------------------------------------------------------------------
# automatic prefix caching (paged, no registration)
# ---------------------------------------------------------------------------

def _auto_sched(**kw):
    return ContinuousBatchingScheduler(_paged_engine(**kw),
                                       eos_token_id=None,
                                       auto_prefix_cache=True)


def test_auto_prefix_multi_turn_reuse():
    """The stateless multi-turn pattern: round 2 resends round 1's whole
    conversation — its pages are still cached, so only the new turn
    prefills. Tokens equal a cold engine's."""
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    sched = _auto_sched()
    prompt1 = list(range(3, 3 + 20))
    r1 = sched.submit(prompt1, sp)
    sched.run(max_steps=500)
    convo = prompt1 + r1.output_ids
    prompt2 = convo + [90, 91, 92]
    r2 = sched.submit(prompt2, sp)
    sched.run(max_steps=500)
    # page=16: conversation is 26 tokens, 25 written -> 1 full page reused
    assert r2.reused_prefix_len == 16
    assert sched.auto_prefix.hits == 1

    cold = ContinuousBatchingScheduler(_paged_engine(), eos_token_id=None)
    c2 = cold.submit(prompt2, sp)
    cold.run(max_steps=500)
    assert r2.output_ids == c2.output_ids


def test_auto_prefix_identical_prompts_and_accounting():
    sp = SamplingParams(greedy=True, max_new_tokens=4)
    sched = _auto_sched()
    total = sched.engine._allocator.num_pages - 1
    prompt = list(range(5, 5 + 33))              # 2 full pages written
    a = sched.submit(prompt, sp)
    sched.run(max_steps=500)
    assert a.reused_prefix_len == 0
    b = sched.submit(prompt, sp)
    sched.run(max_steps=500)
    assert b.reused_prefix_len == 32             # both pages reused
    assert b.output_ids == a.output_ids
    # pool accounting: only the cache's references remain
    cached = sched.auto_prefix.cached_pages
    assert sched.engine.free_pages == total - cached
    sched.auto_prefix.clear()
    assert sched.engine.free_pages == total


def test_auto_prefix_with_penalties_parity():
    sp = SamplingParams(greedy=True, max_new_tokens=6,
                        repetition_penalty=1.4, frequency_penalty=0.3)
    prompt = list(range(7, 7 + 40))
    warm = _auto_sched()
    w1 = warm.submit(prompt, sp)
    warm.run(max_steps=500)
    w2 = warm.submit(prompt, sp)
    warm.run(max_steps=500)
    assert w2.reused_prefix_len > 0
    assert w2.output_ids == w1.output_ids        # counts seeded correctly


def test_auto_prefix_lru_budget():
    sp = SamplingParams(greedy=True, max_new_tokens=3)
    sched = ContinuousBatchingScheduler(
        _paged_engine(), eos_token_id=None, auto_prefix_cache=True,
        auto_prefix_pages=3)
    total = sched.engine._allocator.num_pages - 1
    for base in (10, 60, 110, 160):
        sched.submit(list(range(base, base + 20)), sp)
        sched.run(max_steps=500)
    assert sched.auto_prefix.cached_pages <= 3
    assert sched.engine.free_pages == total - sched.auto_prefix.cached_pages


def test_auto_prefix_mid_prefill_finish_not_poisoned():
    """A request finishing mid-prefill (cancel) has written only
    prefill_pos cache rows; donating more would cache a partially
    written page under a full-page key and poison later matches
    (ADVICE r1 high: warm output diverged from a cold engine)."""
    sp = SamplingParams(greedy=True, max_new_tokens=4)
    eng = EngineConfig(max_batch_size=2, max_seq_len=96,
                       max_prefill_len=8, kv_layout="paged", page_size=16)
    sched = ContinuousBatchingScheduler(
        InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=0)),
        eos_token_id=None, auto_prefix_cache=True)
    prompt = list(range(3, 3 + 24))
    r = sched.submit(prompt, sp)
    sched.step()                      # admit + first 8-token chunk only
    assert r.prefill_pos == 8
    assert sched.cancel(r)            # donation must clamp to 8 -> 0 pages
    assert sched.auto_prefix.match_len(prompt + [99]) == 0
    r2 = sched.submit(prompt, sp)
    sched.run(max_steps=500)

    cold = ContinuousBatchingScheduler(_paged_engine(), eos_token_id=None)
    c = cold.submit(prompt, sp)
    cold.run(max_steps=500)
    assert r2.output_ids == c.output_ids


def test_auto_prefix_eos_finish_donates_full_context():
    """An EOS finish wrote every context token (the stop token is neither
    appended nor written), so the full page-aligned context is reusable
    (ADVICE r1 low: a uniform -1 dropped up to a page per turn)."""
    probe = _auto_sched()
    p1 = probe.submit(list(range(3, 3 + 30)),
                      SamplingParams(greedy=True, max_new_tokens=6))
    probe.run(max_steps=500)
    assert len(p1.output_ids) == 6

    prompt = list(range(3, 3 + 30))
    stop = p1.output_ids[2]           # third generated token becomes EOS
    sched = _auto_sched()
    r = sched.submit(prompt, SamplingParams(greedy=True, max_new_tokens=6,
                                            stop_token_ids=[stop]))
    sched.run(max_steps=500)
    assert r.finish_reason == "eos" and len(r.output_ids) == 2
    ctx = prompt + r.output_ids       # 32 tokens, ALL written
    assert sched.auto_prefix.match_len(list(ctx) + [99]) == 32


def test_auto_prefix_eviction_under_admission_pressure():
    """Idle cached chains must never starve new work: when admission
    cannot get pages, LRU chains are evicted back to the pool
    (ADVICE r1 high: pinned pages hung every subsequent request)."""
    sp = SamplingParams(greedy=True, max_new_tokens=3)
    sched = ContinuousBatchingScheduler(
        _paged_engine(), eos_token_id=None, auto_prefix_cache=True,
        auto_prefix_pages=1024)       # cap alone won't save the pool
    for base in (10, 60, 110, 160, 210):
        sched.submit(list(range(base, base + 40)), sp)
        sched.run(max_steps=500)
    assert sched.auto_prefix.cached_pages >= 8    # pool nearly pinned
    r = sched.submit(list(range(300, 300 + 80)), sp)
    sched.run(max_steps=500)
    assert r.finished and len(r.output_ids) == 3


def test_auto_prefix_admission_credits_cached_pages():
    """Admission must not charge pages the cache will serve: a cache-hit
    request admits under pressure AND keeps its reuse (ADVICE r1 low:
    gating charged full price, then pressure evicted exactly the pages
    the request would have reused)."""
    sp_short = SamplingParams(greedy=True, max_new_tokens=3)
    sched = _auto_sched()
    long_prompt = list(range(3, 3 + 80))          # 5 pages cached after
    sched.submit(long_prompt, sp_short)
    sched.run(max_steps=500)
    assert sched.auto_prefix.match_len(long_prompt + [99]) == 80
    # occupy pages with a live request so free < full-price need
    live = sched.submit(list(range(400, 400 + 60)),
                        SamplingParams(greedy=True, max_new_tokens=30))
    sched.step()
    assert live.slot >= 0
    r = sched.submit(long_prompt + [90, 91], sp_short)
    sched.run(max_steps=500)
    assert r.reused_prefix_len == 80              # hit survived admission
    assert r.finished and len(r.output_ids) == 3
    assert live.finished
