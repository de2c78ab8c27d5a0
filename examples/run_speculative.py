"""Speculative decoding driver: a draft model proposes K tokens, the
target verifies them in one forward (capability beyond the reference's
entire design — its decode loop was one model, one token, one D2H per
step, llama.cpp:322-398)."""

import sys, os
sys.path.insert(0, os.path.dirname(__file__))
import _common  # noqa: F401
from _common import report

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.engine import InferenceEngine
from llm_inference_engine.runtime.speculative import SpeculativeDecoder

cfg = get_config("debug")
eng = EngineConfig(max_batch_size=1, max_seq_len=96)
target = InferenceEngine(cfg, eng, init_dummy_params(cfg, seed=0, scale=0.3))
draft = InferenceEngine(cfg, eng, init_dummy_params(cfg, seed=0, scale=0.3))

prompt = [[1, 17, 93, 5]]
target.reset()
want = target.generate(prompt, SamplingParams(greedy=True,
                                              max_new_tokens=12),
                       eos_token_id=None).token_ids

spec = SpeculativeDecoder(target, draft, num_draft=3)
res = spec.generate(prompt, max_new_tokens=12, eos_token_id=None)
print("  greedy:", want[0])
print("  spec:  ", res.token_ids[0],
      f"(acceptance {res.acceptance_rate:.0%})")
# identical draft == target: high acceptance; exactness is bit-for-bit in
# f32 and tie-flip-limited under bf16 rounding noise
report("speculative decoding", res.acceptance_rate > 0.5,
       f"acceptance {res.acceptance_rate:.0%}, "
       f"{res.num_accepted}/{res.num_drafted} drafts accepted")
