"""Serving-stack driver: paged KV pool, prefix caching, speculative
rounds, cancellation — the features the reference (one blocking bs=1
response() per request, llama.cpp:322) never had, all over dummy-weight
debug engines."""

import sys, os
sys.path.insert(0, os.path.dirname(__file__))
import _common  # noqa: F401
from _common import report

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.engine import InferenceEngine
from llm_inference_engine.runtime.scheduler import ContinuousBatchingScheduler
from llm_inference_engine.runtime.speculative_scheduler import (
    SpeculativeScheduler)

CFG = get_config("debug")


def engine(layout="slot", seed=0, **kw):
    return InferenceEngine(
        CFG, EngineConfig(max_batch_size=2, max_seq_len=64,
                          max_prefill_len=8, kv_layout=layout, page_size=16,
                          **kw),
        init_dummy_params(CFG, seed=seed))


SP = SamplingParams(greedy=True, max_new_tokens=6)
PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [4, 4, 5, 5], list(range(3, 25))]

# 1. baseline: plain continuous batching
plain = ContinuousBatchingScheduler(engine(), eos_token_id=None)
want = [plain.submit(p, SP) for p in PROMPTS]
plain.run()
want = [r.output_ids for r in want]

# 2. paged pool (memory bounded by tokens in flight), same tokens
paged = ContinuousBatchingScheduler(engine("paged"), eos_token_id=None)
got = [paged.submit(p, SP) for p in PROMPTS]
paged.run(max_steps=1000)
report("paged KV serving matches slot layout",
       [r.output_ids for r in got] == want,
       f"pool free again: {paged.engine.free_pages} pages")

# 3. prefix caching: register a shared prefix, reuse across requests
pref = ContinuousBatchingScheduler(engine(), eos_token_id=None)
prefix = list(range(5, 21))
pref.register_prefix(prefix)
reqs = [pref.submit(prefix + [40 + i], SP) for i in range(3)]
pref.run()
base = ContinuousBatchingScheduler(engine(), eos_token_id=None)
base_reqs = [base.submit(prefix + [40 + i], SP) for i in range(3)]
base.run()
report("prefix caching (reuse == recompute)",
       [r.output_ids for r in reqs] == [r.output_ids for r in base_reqs],
       f"each request skipped {reqs[0].reused_prefix_len} prefix tokens")

# 4. speculative serving: disagreeing draft, lossless tokens
spec = SpeculativeScheduler(engine(), engine(seed=1), eos_token_id=None,
                            num_draft=3)
sreqs = [spec.submit(p, SP) for p in PROMPTS]
spec.run(max_steps=1000)
report("speculative serving lossless vs plain",
       [r.output_ids for r in sreqs] == want,
       f"acceptance {spec.acceptance_rate:.0%}, "
       f"{spec.num_accepted}/{spec.num_drafted} drafts accepted")

# 5. cancellation + latency accounting
canc = ContinuousBatchingScheduler(engine(), eos_token_id=None)
a = canc.submit([1, 2, 3], SP)
b = canc.submit([7, 7, 7], SP)
canc.step()
canc.cancel(b)
canc.run()
report("cancellation frees the slot; latency accounted",
       a.finished and b.finish_reason == "cancelled"
       and a.ttft is not None and a.e2e_latency >= a.ttft,
       f"a: ttft {a.ttft * 1e3:.0f} ms, e2e {a.e2e_latency * 1e3:.0f} ms")
