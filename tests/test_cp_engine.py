"""Context-parallel ENGINE parity: cp>1 must produce the same tokens and
logits as the single-device engine.

VERDICT r3 ask #4: context parallelism must be an engine capability, not a
module with templates — EngineConfig(cp=...) routes prefill through ring
attention and decode through split-KV flash-decoding over the mesh's
``seq`` axis (parallel/cp_engine.py), with the append-log cache layout
(parallel/cp_cache.py). These tests pin token/logits parity against the
cp=1 engine on the 8-virtual-device CPU mesh, including chunked ragged
prefill, sampled rollout decode, multi-round append, slot reset, and
composition with tensor/data parallelism.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from llm_inference_engine.config import (EngineConfig, SamplingParams,
                                             get_config)
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.engine import InferenceEngine

CFG = get_config("debug")           # 4 heads, 2 kv heads, vocab 256, fp32


def make_engine(cp=1, tp=1, dp=1, seed=0, **kw):
    eng = EngineConfig(max_batch_size=4, max_seq_len=64, max_prefill_len=16, cp=cp, tp=tp, dp=dp, **kw)
    params = init_dummy_params(CFG, seed=seed)
    return InferenceEngine(CFG, eng, params, rng_seed=0)


def prompts_for(rng, lens):
    return [rng.integers(0, CFG.vocab_size, size=n).tolist() for n in lens]


def test_cp2_prefill_logits_parity(rng):
    """Chunked ragged prefill (lengths straddle the 16-token chunk)."""
    base = make_engine()
    cpe = make_engine(cp=2)
    prompts = prompts_for(rng, [7, 16, 23, 3])
    want = np.asarray(base.prefill(prompts))
    got = np.asarray(cpe.prefill(prompts))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_cp2_generate_token_parity(rng):
    base = make_engine()
    cpe = make_engine(cp=2)
    prompts = prompts_for(rng, [9, 17, 5, 12])
    sp = SamplingParams(greedy=True, max_new_tokens=10)
    want = base.generate(prompts, sp, eos_token_id=None)
    got = cpe.generate(prompts, sp, eos_token_id=None)
    assert got.token_ids == want.token_ids


def test_cp2_decode_steps_parity(rng):
    """Per-token decode_step path (streaming) with a partially active
    batch: the least-full-rank append rule must stay in lockstep."""
    base = make_engine()
    cpe = make_engine(cp=2)
    prompts = prompts_for(rng, [6, 11, 3, 19])
    sp = SamplingParams(greedy=True)
    lb = base.prefill(prompts)
    lc = cpe.prefill(prompts)
    tb = jnp.argmax(lb, -1).astype(jnp.int32)
    tc = jnp.argmax(lc, -1).astype(jnp.int32)
    active = np.array([True, True, False, True])
    for _ in range(6):
        tb = base.decode_step(tb, active, sp)
        tc = cpe.decode_step(tc, active, sp)
        np.testing.assert_array_equal(np.asarray(tc)[active],
                                      np.asarray(tb)[active])


def test_cp2_multiround_append_parity(rng):
    """Round 2 prefill appends on top of the decode-extended logs."""
    base = make_engine()
    cpe = make_engine(cp=2)
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    r1 = prompts_for(rng, [8, 5, 14, 7])
    want1 = base.generate(r1, sp, eos_token_id=None)
    got1 = cpe.generate(r1, sp, eos_token_id=None)
    assert got1.token_ids == want1.token_ids
    r2 = prompts_for(rng, [6, 9, 4, 11])
    want = np.asarray(base.prefill(r2))
    got = np.asarray(cpe.prefill(r2))
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)


def test_cp2_reset_slots(rng):
    cpe = make_engine(cp=2)
    prompts = prompts_for(rng, [12, 8, 6, 10])
    cpe.prefill(prompts)
    cpe.reset([1, 3])
    lens = np.asarray(cpe.cache.lengths)
    np.testing.assert_array_equal(lens[[1, 3]], [0, 0])
    llen = np.asarray(cpe.cache.llen)
    assert (llen[[1, 3]] == 0).all() and (llen[[0, 2]].sum(1) == [12, 6]).all()
    # refill the cleared slots; untouched slots keep their history
    base = make_engine()
    base.prefill(prompts)
    base.reset([1, 3])
    p2 = prompts_for(rng, [5, 9])
    want = np.asarray(base.prefill(p2, slots=[1, 3]))
    got = np.asarray(cpe.prefill(p2, slots=[1, 3]))
    np.testing.assert_allclose(got[[1, 3]], want[[1, 3]],
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("cp,tp,dp", [(2, 2, 1), (2, 1, 2), (2, 2, 2)])
def test_cp_composes_with_tp_dp(rng, cp, tp, dp):
    base = make_engine()
    cpe = make_engine(cp=cp, tp=tp, dp=dp)
    prompts = prompts_for(rng, [7, 13, 4, 9])
    sp = SamplingParams(greedy=True, max_new_tokens=8)
    want = base.generate(prompts, sp, eos_token_id=None)
    got = cpe.generate(prompts, sp, eos_token_id=None)
    assert got.token_ids == want.token_ids


def test_cp_local_capacity_guard(rng):
    """Ragged chunked prefill that would overflow rank 0's log raises
    (either the padded-window shrink check or the llen mirror fires —
    both refuse loudly instead of shift-corrupting the log)."""
    cpe = make_engine(cp=2)
    # chunks of <=16 bucket to 16 (t_local=8); 9-token chunks put 8 rows
    # on rank 0 and 1 on rank 1 per call -> rank 0 fills at ~8/call
    with pytest.raises(ValueError, match="local KV log|cannot fit"):
        for _ in range(8):
            cpe.prefill([[1] * 9, [], [], []], slots=[0, 1, 2, 3])


def test_cp_multiround_append_near_capacity(rng):
    """Appends whose padded windows approach the per-rank log capacity
    still reproduce the cp=1 engine exactly (the chunk bucket shrinks
    instead of letting the local write start clamp and shift)."""
    base = make_engine()
    cpe = make_engine(cp=2)
    toks = rng.integers(0, CFG.vocab_size, size=58).tolist()
    # 48 (even 16-chunks, logs 24/24) + 6 (logs 30/24) + 4: rank 0 has 2
    # rows left, so the 4-token append must shrink its bucket to 4
    # (t_local=2) to fit — the shift-corrupting clamp never engages
    for e in (base, cpe):
        e.prefill([toks[:48], [], [], []], slots=[0, 1, 2, 3])
        e.prefill([toks[48:54], [], [], []], slots=[0, 1, 2, 3])
    got = np.asarray(cpe.prefill([toks[54:58], [], [], []],
                                 slots=[0, 1, 2, 3]))
    want = np.asarray(base.prefill([toks[54:58], [], [], []],
                                   slots=[0, 1, 2, 3]))
    np.testing.assert_allclose(got[0], want[0], atol=3e-4, rtol=3e-4)
    assert int(np.asarray(cpe.cache.llen)[0].max()) <= 32


def test_cp_guards_paged_and_quantized():
    params = init_dummy_params(CFG, seed=0)
    with pytest.raises(NotImplementedError, match="paged"):
        InferenceEngine(CFG, EngineConfig(
            max_batch_size=4, max_seq_len=64, max_prefill_len=16, cp=2, kv_layout="paged"), params)
    with pytest.raises(NotImplementedError, match="bf16 or int8"):
        InferenceEngine(CFG, EngineConfig(
            max_batch_size=4, max_seq_len=64, max_prefill_len=16, cp=2, kv_cache_dtype_name="float16"), params)


# ---------------------------------------------------------------------------
# INT8 KV log (VERDICT r4 #4: cp must multiply the QUANTIZED capacity too)
# ---------------------------------------------------------------------------

def test_cp2_int8_cache_is_int8(rng):
    cpe = make_engine(cp=2, kv_cache_dtype_name="int8")
    assert cpe.cache.k.dtype == jnp.int8
    assert cpe.cache.quantized and cpe.cache.k_scale is not None
    # same quantizer as the cp=1 slot cache -> bytes halve vs bf16 rows
    assert cpe.cache.k.dtype.itemsize * 2 == jnp.dtype(jnp.bfloat16).itemsize


def test_cp2_int8_prefill_logits_parity(rng):
    """cp=2 int8 log vs cp=1 int8 slot cache: same per-(token, head)
    absmax quantizer, so logits agree to fp-reassociation tolerance."""
    base = make_engine(kv_cache_dtype_name="int8")
    cpe = make_engine(cp=2, kv_cache_dtype_name="int8")
    prompts = prompts_for(rng, [7, 16, 23, 3])
    want = np.asarray(base.prefill(prompts))
    got = np.asarray(cpe.prefill(prompts))
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)


def test_cp2_int8_generate_token_parity(rng):
    base = make_engine(kv_cache_dtype_name="int8")
    cpe = make_engine(cp=2, kv_cache_dtype_name="int8")
    prompts = prompts_for(rng, [9, 17, 5, 12])
    sp = SamplingParams(greedy=True, max_new_tokens=10)
    want = base.generate(prompts, sp, eos_token_id=None)
    got = cpe.generate(prompts, sp, eos_token_id=None)
    assert got.token_ids == want.token_ids


def test_cp2_int8_multiround_append_parity(rng):
    base = make_engine(kv_cache_dtype_name="int8")
    cpe = make_engine(cp=2, kv_cache_dtype_name="int8")
    sp = SamplingParams(greedy=True, max_new_tokens=6)
    r1 = prompts_for(rng, [8, 5, 14, 7])
    want1 = base.generate(r1, sp, eos_token_id=None)
    got1 = cpe.generate(r1, sp, eos_token_id=None)
    assert got1.token_ids == want1.token_ids
    r2 = prompts_for(rng, [6, 9, 4, 11])
    want = np.asarray(base.prefill(r2))
    got = np.asarray(cpe.prefill(r2))
    np.testing.assert_allclose(got, want, atol=4e-4, rtol=4e-4)


def test_cp2_int8_composes_with_tp(rng):
    base = make_engine(kv_cache_dtype_name="int8")
    cpe = make_engine(cp=2, tp=2, kv_cache_dtype_name="int8")
    prompts = prompts_for(rng, [7, 13, 4, 9])
    sp = SamplingParams(greedy=True, max_new_tokens=8)
    want = base.generate(prompts, sp, eos_token_id=None)
    got = cpe.generate(prompts, sp, eos_token_id=None)
    assert got.token_ids == want.token_ids
