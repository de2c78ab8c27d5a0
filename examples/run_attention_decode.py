"""Decode (single-token) attention driver.

The reference's fused masked MHA example attends one new token against the
cache per block (reference: examples/cpp/self_attention_example,
decoder_self_attention.cu:211-270). Here decode is the Sq=1 case of the
same flash kernel — this driver also exercises the INT8-quantized KV cache
(quantize-on-write, dequantize-in-kernel), the capability the reference
only declared (base_weights.h:10).
"""

import sys, os
sys.path.insert(0, os.path.dirname(__file__))
import _common  # noqa: F401
from _common import report

import jax
import jax.numpy as jnp

from llm_inference_engine.ops import kv_cache as kvc
from llm_inference_engine.ops.attention import attention, attention_ref

B, H, K, D, S = 4, 8, 2, 64, 128

key = jax.random.PRNGKey(1)
kq, kk, kv, kn = jax.random.split(key, 4)
q = jax.random.normal(kq, (B, 1, H, D), jnp.float32)
k_new = jax.random.normal(kk, (B, 1, K, D), jnp.float32)
v_new = jax.random.normal(kv, (B, 1, K, D), jnp.float32)

# per-sequence histories of different lengths
q_start = jnp.array([17, 0, 63, 5], jnp.int32)
kv_len = q_start + 1

# fp16-path cache
cache = kvc.new_kv_cache(1, B, K, S, D, dtype=jnp.float32)
k_layer, v_layer, _, _ = kvc.update_layer_cache(
    cache.k[0], cache.v[0], k_new, v_new, q_start)
out = attention(q, k_layer, v_layer, q_start, kv_len)
ref = attention_ref(q, k_layer, v_layer, q_start, kv_len)
err = float(jnp.max(jnp.abs(out - ref)))
report("decode attention vs dense golden", err < 2e-5, f"max err {err:.2e}")

# INT8 KV cache path
qcache = kvc.new_kv_cache(1, B, K, S, D, dtype=jnp.float32, quantized=True)
k8, v8, ks, vs = kvc.update_layer_cache(
    qcache.k[0], qcache.v[0], k_new, v_new, q_start,
    qcache.k_scale[0], qcache.v_scale[0])
out8 = attention(q, k8, v8, q_start, kv_len,
                 k_scale=ks, v_scale=vs)
err8 = float(jnp.max(jnp.abs(out8 - ref)))
report("decode attention with INT8 KV cache", err8 < 0.05,
       f"max err vs fp golden {err8:.2e}")
