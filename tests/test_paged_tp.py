"""Paged KV cache x tensor/data parallelism (VERDICT r2 ask #3).

The page pool shards its kv-head axis over the model axis (every shard
holds its heads of every page, one global block table), block-table rows
and lengths over the data axis; pool page-content divergence across data
groups is confined to pages the other groups' slots own (see
parallel/sharding.py docstring). Parity gate: a paged engine on a dp x tp
mesh must generate token-for-token what the single-device paged engine
does (which itself matches the slot engine, tests/test_paged_kv.py).
"""

import jax
import numpy as np
import pytest

from llm_inference_engine.config import (EngineConfig, SamplingParams,
                                             get_config)
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.parallel import make_mesh
from llm_inference_engine.runtime.engine import InferenceEngine

CFG = get_config("debug")          # 4 heads, 2 kv heads, vocab 256


def _engine(mesh=None, B=4, **kw):
    eng = EngineConfig(max_batch_size=B, max_seq_len=64,
                       max_prefill_len=8, kv_layout="paged", page_size=16,
                       **kw)
    return InferenceEngine(CFG, eng, init_dummy_params(CFG, seed=0),
                           mesh=mesh)


PROMPTS = [list(range(1, 20)), [9, 8, 7], [30, 31], list(range(40, 52))]


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 1), (2, 2)])
def test_paged_mesh_generate_matches_single_device(dp, tp):
    sp = SamplingParams(greedy=True, max_new_tokens=10)
    want = _engine().generate(PROMPTS, sp, eos_token_id=None)

    mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices("cpu"))
    meshed = _engine(mesh=mesh)
    got = meshed.generate(PROMPTS, sp, eos_token_id=None)
    assert got.token_ids == want.token_ids
    # page accounting is host-side and unchanged by the mesh
    assert [len(p) for p in meshed._slot_pages] == \
        [len(p) for p in _engine_pages_single()]


def _engine_pages_single():
    sp = SamplingParams(greedy=True, max_new_tokens=10)
    e = _engine()
    e.generate(PROMPTS, sp, eos_token_id=None)
    return e._slot_pages


def test_paged_mesh_scheduler_round_trip():
    """Continuous batching over a paged dp x tp mesh engine: admissions,
    chunked prefill, decode, completion — tokens match the single-device
    paged scheduler."""
    from llm_inference_engine.runtime.scheduler import (
        ContinuousBatchingScheduler)
    sp = SamplingParams(greedy=True, max_new_tokens=6)

    def run(engine):
        sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
        reqs = [sched.submit(p, sp) for p in PROMPTS]
        sched.run()
        return [r.output_ids for r in reqs]

    want = run(_engine())
    mesh = make_mesh(dp=2, tp=2, devices=jax.devices("cpu"))
    got = run(_engine(mesh=mesh))
    assert got == want


def test_paged_mesh_preemption_recompute():
    """Pool pressure under a mesh: preempted requests recompute and finish
    with the same tokens as an unpressured run (divergent-replica safety:
    released pages get rewritten by other slots on the same data group)."""
    from llm_inference_engine.runtime.scheduler import (
        ContinuousBatchingScheduler)
    sp = SamplingParams(greedy=True, max_new_tokens=8)
    long_prompts = [list(range(1, 17)), list(range(20, 36)),
                    list(range(40, 56)), list(range(60, 76))]

    want = run_tokens = None
    want = _run_sched(_engine(num_pages=0), long_prompts, sp)
    mesh = make_mesh(dp=2, tp=2, devices=jax.devices("cpu"))
    # a tight pool forces preemption (each ctx needs 2 pages; 4 slots
    # want 8+ pages as they grow)
    got = _run_sched(_engine(mesh=mesh, num_pages=8), long_prompts, sp)
    assert got == want


def _run_sched(engine, prompts, sp):
    from llm_inference_engine.runtime.scheduler import (
        ContinuousBatchingScheduler)
    sched = ContinuousBatchingScheduler(engine, eos_token_id=None)
    reqs = [sched.submit(p, sp) for p in prompts]
    sched.run()
    return [r.output_ids for r in reqs]


def test_paged_mesh_int8_pool_guarded():
    mesh = make_mesh(dp=1, tp=2, devices=jax.devices("cpu"))
    with pytest.raises(NotImplementedError, match="scale"):
        _engine(mesh=mesh, kv_cache_dtype_name="int8")
