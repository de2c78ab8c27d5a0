"""Beam-search driver (the reference shipped launchTopKForBeamSearch and a
beamwidth field but never wired beams; topk.cu:104-140, llama.h:42)."""

import sys, os
sys.path.insert(0, os.path.dirname(__file__))
import _common  # noqa: F401
from _common import report

from llm_inference_engine.config import EngineConfig, get_config
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.beam_search import beam_search

cfg = get_config("debug")
eng = EngineConfig(max_batch_size=4, max_seq_len=64)
params = init_dummy_params(cfg, seed=3, scale=0.35)

res = beam_search(cfg, eng, params, [1, 9, 41, 7], num_beams=4,
                  max_new_tokens=8, eos_token_id=None, length_penalty=0.0)
for seq, score in zip(res.sequences, res.scores):
    print(f"  score {score:8.3f}  tokens {seq}")
report("beam search (4 beams)",
       res.scores == sorted(res.scores, reverse=True)
       and len(res.sequences) == 4,
       "beams sorted best-first")
