"""Prefill (context) attention driver.

The reference's context-attention example wired qkv GEMM -> RoPE -> cache
concat -> GQA repeat -> batched GEMMs -> fused softmax by hand
(reference: examples/cpp/context_attention_example, layer chain
context_attention.cpp:144-304). Here the whole chain past the projection is
ONE attention op; this driver runs it on ragged batched sequences with
history and checks it against the dense f32 reference.
"""

import sys, os
sys.path.insert(0, os.path.dirname(__file__))
import _common  # noqa: F401  (repo path, matmul precision)
from _common import report

import jax
import jax.numpy as jnp
import numpy as np

from llm_inference_engine.ops.attention import attention, attention_ref

B, Sq, H, K, D, Skv = 2, 16, 8, 4, 32, 64

key = jax.random.PRNGKey(0)
kq, kk, kv = jax.random.split(key, 3)
q = jax.random.normal(kq, (B, Sq, H, D), jnp.float32)
k_cache = jax.random.normal(kk, (B, Skv, K, D), jnp.float32)
v_cache = jax.random.normal(kv, (B, Skv, K, D), jnp.float32)

# ragged: sequence 0 has 5 tokens of history + 16 new; sequence 1 has 0 + 9
q_start = jnp.array([5, 0], jnp.int32)
kv_len = jnp.array([5 + 16, 9], jnp.int32)

out = attention(q, k_cache, v_cache, q_start, kv_len)
ref = attention_ref(q, k_cache, v_cache, q_start, kv_len)

err = float(jnp.max(jnp.abs(out - ref)))
report("prefill attention vs dense f32 reference", err < 2e-5,
       f"max abs err {err:.2e}, shapes q{tuple(q.shape)} kv{tuple(k_cache.shape)}")
