"""Tensor-parallel forward on a virtual 8-device CPU mesh.

The capability tier the reference lacked entirely (SURVEY.md §2f: no
NCCL/MPI, single device, bs=1): Megatron-style TP — qkv/gate_up
column-sharded, o/down row-sharded with one psum each — over a
jax.sharding Mesh. Run on virtual CPU devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/run_sharded_tp.py
"""

import os
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import sys
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")  # env vars may be overridden here

import _common  # noqa: F401
from _common import report

import jax
import jax.numpy as jnp

from llm_inference_engine.config import EngineConfig, get_config
from llm_inference_engine.models import llama as M
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.ops import kv_cache as kvc
from llm_inference_engine.parallel import make_mesh, sharding
from llm_inference_engine.utils import cpu_devices

devices = cpu_devices(8)

cfg = get_config("debug").replace(num_kv_heads=4, num_heads=8)
dp, tp = 2, 4
B = 4
eng = EngineConfig(max_batch_size=B, max_seq_len=32,
                   dp=dp, tp=tp)
mesh = make_mesh(dp=dp, tp=tp, devices=devices)

params = init_dummy_params(cfg, seed=0, scale=0.3)
ids = jnp.ones((B, 6), jnp.int32)
q0 = jnp.zeros((B,), jnp.int32)
lens = jnp.full((B,), 6, jnp.int32)

# single-device golden
cache0 = kvc.new_kv_cache(cfg.num_layers, B, cfg.num_kv_heads, 32,
                          cfg.head_dim, dtype=cfg.dtype)
want, _ = M.forward_hidden(cfg, eng, params, ids, cache0, q0, lens)

# sharded
sparams = sharding.shard_params(params, mesh)
scache = sharding.shard_cache(
    kvc.new_kv_cache(cfg.num_layers, B, cfg.num_kv_heads, 32, cfg.head_dim,
                     dtype=cfg.dtype), mesh)
fwd = jax.jit(sharding.make_sharded_forward(cfg, eng, mesh, sparams))
got, _ = fwd(sparams, scache, ids, q0, lens)

err = float(jnp.max(jnp.abs(got - want)))
report(f"TP{tp} x DP{dp} sharded forward == single-device", err < 1e-3,
       f"max err {err:.2e} on mesh {mesh.shape}")
