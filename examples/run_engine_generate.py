"""Engine API driver: batched generation with streaming callback
(reference: the response loop llama.cpp:322-398 + CallBack protocol
basemodel.h:12, but batched — the reference was pinned to bs=1,
llama.h:31)."""

import sys, os
sys.path.insert(0, os.path.dirname(__file__))
import _common  # noqa: F401
from _common import report

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.engine import InferenceEngine

cfg = get_config("debug")
engine = InferenceEngine(cfg, EngineConfig(max_batch_size=3, max_seq_len=64),
                         init_dummy_params(cfg, seed=0, scale=0.3))

streamed = []
res = engine.generate(
    [[1, 17, 93, 5], [1, 9], [1, 200, 3, 77, 4]],
    SamplingParams(greedy=True, max_new_tokens=8),
    eos_token_id=None,
    stream_callback=lambda i, t: streamed.append((i, t)))

print("generated:", res.token_ids)
report("batched greedy generation", all(len(s) == 8 for s in res.token_ids),
       f"{sum(res.num_generated)} tokens streamed in {len(streamed)} callbacks")

# determinism: same prompts after reset -> same tokens
engine.reset()
res2 = engine.generate([[1, 17, 93, 5], [1, 9], [1, 200, 3, 77, 4]],
                       SamplingParams(greedy=True, max_new_tokens=8),
                       eos_token_id=None)
report("deterministic after reset", res2.token_ids == res.token_ids)
