"""Context-parallel engine on a virtual 8-device CPU mesh.

Beyond-one-chip sequence capacity (SURVEY.md §5 long-context row — the
reference was single-GPU with max_seq_len=64): EngineConfig(cp=N) splits
the KV cache's token capacity over the mesh's ``seq`` axis, runs prefill
as ring attention (ppermute between devices) and decode as split-KV
flash-decoding (pmax/psum combine), with the per-rank append-log cache
layout (parallel/cp_cache.py). Run on virtual CPU devices:

  python examples/run_context_parallel.py

Asserts the cp=2 x dp=2 engine reproduces the single-device engine's
greedy tokens exactly (exit 1 on mismatch).
"""

import os
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import sys
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")

import _common  # noqa: F401
from _common import report

from llm_inference_engine.config import (EngineConfig, SamplingParams,
                                             get_config)
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.runtime.engine import InferenceEngine

cfg = get_config("debug")
params = init_dummy_params(cfg, seed=0)
prompts = [[1, 17, 93, 5], [7, 9, 23], [2, 4, 6, 8, 10], [11]]
sp = SamplingParams(greedy=True, max_new_tokens=8)

base = InferenceEngine(
    cfg, EngineConfig(max_batch_size=4, max_seq_len=64, max_prefill_len=16),
    params)
want = base.generate(prompts, sp, eos_token_id=None).token_ids

cpe = InferenceEngine(
    cfg, EngineConfig(max_batch_size=4, max_seq_len=64, max_prefill_len=16,
                      cp=2, dp=2), params)
got = cpe.generate(prompts, sp, eos_token_id=None).token_ids

print("single-device:", want)
print("cp=2 x dp=2  :", got)
print("per-rank KV rows used (llen):")
import numpy as np
print(np.asarray(cpe.cache.llen))

report("context-parallel engine token parity (cp=2 x dp=2)", got == want)
