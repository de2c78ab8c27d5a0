"""Full decoder driver: multi-layer prefill then step-by-step decode
(reference: examples/cpp/context_decoder_example +
self_decoder_example — per-layer sandwich context_decoder.cpp:127-190 /
self_decoder.cpp:69-119 with dummy weights). Asserts that incremental
decode over the KV cache reproduces the all-at-once forward."""

import sys, os
sys.path.insert(0, os.path.dirname(__file__))
import _common  # noqa: F401
from _common import report

import jax.numpy as jnp
import numpy as np

from llm_inference_engine.config import EngineConfig, get_config
from llm_inference_engine.models import llama as M
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.ops import kv_cache as kvc

cfg = get_config("debug")
eng = EngineConfig(max_batch_size=1, max_seq_len=32)
params = init_dummy_params(cfg, seed=0, scale=0.3)

toks = np.array([[1, 7, 42, 99, 5, 13, 27, 3]], np.int32)
T = toks.shape[1]

# all-at-once prefill
cache = kvc.new_kv_cache(cfg.num_layers, 1, cfg.num_kv_heads, 32,
                         cfg.head_dim, dtype=cfg.dtype)
logits_full, _ = M.forward_hidden(cfg, eng, params, jnp.asarray(toks), cache,
                                  jnp.zeros((1,), jnp.int32),
                                  jnp.array([T], jnp.int32))

# token-by-token decode from an empty cache
cache = kvc.new_kv_cache(cfg.num_layers, 1, cfg.num_kv_heads, 32,
                         cfg.head_dim, dtype=cfg.dtype)
for t in range(T):
    logits_step, cache = M.forward_hidden(
        cfg, eng, params, jnp.asarray(toks[:, t:t + 1]), cache,
        jnp.array([t], jnp.int32), jnp.array([t + 1], jnp.int32))

err = float(jnp.max(jnp.abs(logits_full - logits_step)))
report("prefill == incremental decode (last-token logits)", err < 1e-3,
       f"max logits err {err:.2e} over {cfg.num_layers} layers")
