"""Quantization driver: INT8/INT4 weight-only matmuls and a quantized
end-to-end forward — the capability the reference planned but never built
(reference: README.md:36-39, base_weights.h:10 unused INT8_W enum)."""

import sys, os
sys.path.insert(0, os.path.dirname(__file__))
import _common  # noqa: F401
from _common import report

import jax
import jax.numpy as jnp

from llm_inference_engine.config import EngineConfig, SamplingParams, get_config
from llm_inference_engine.models.weights import init_dummy_params, quantize_params
from llm_inference_engine.ops.quant import (
    dequantize_tensor, quantize_tensor, quantized_linear)
from llm_inference_engine.runtime.engine import InferenceEngine

# --- op level ---
key = jax.random.PRNGKey(0)
kx, kw = jax.random.split(key)
x = jax.random.normal(kx, (16, 256), jnp.float32)
w = jax.random.normal(kw, (256, 512), jnp.float32) * 0.1

for mode in ("int8", "int4"):
    t = quantize_tensor(w, mode, group_size=128)
    y = quantized_linear(x, t)
    want = x @ dequantize_tensor(t)          # exact: same quantized weights
    err = float(jnp.max(jnp.abs(y - want)))
    qerr = float(jnp.max(jnp.abs(x @ w - want)))
    report(f"{mode} weight-only matmul", err < 1e-3,
           f"op-vs-dequant err {err:.2e} (quantization err {qerr:.2e})")

# --- model level: quantized logits stay close to fp (token trajectories
# on a *random* model are chaotic, so the meaningful check is the logit
# gap on the same prefix, the same thing the PPL delta gate measures) ---
cfg = get_config("debug")
params = init_dummy_params(cfg, seed=0, scale=0.3)
p_int8 = quantize_params(params, "int8", group_size=32)

fp = InferenceEngine(cfg, EngineConfig(max_batch_size=1, max_seq_len=64),
                     params)
q8 = InferenceEngine(cfg, EngineConfig(max_batch_size=1, max_seq_len=64,
                                       quant_mode="int8"), p_int8)
prompt = [[1, 17, 93, 5]]
la = fp.prefill(prompt)
lb = q8.prefill(prompt)
pa = jax.nn.softmax(la.astype(jnp.float32), -1)
pb = jax.nn.softmax(lb.astype(jnp.float32), -1)
tv = float(0.5 * jnp.abs(pa - pb).sum(-1).max())   # total-variation distance
report("int8 model logits track fp", tv < 0.2,
       f"max TV distance {tv:.4f}, argmax agree: "
       f"{bool((pa.argmax(-1) == pb.argmax(-1)).all())}")
