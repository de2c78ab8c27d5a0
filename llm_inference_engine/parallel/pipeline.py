"""Pipeline parallelism (layer stages over a ``pipe`` mesh axis).

The reference is single-device (SURVEY.md §2f); this is the third
parallelism axis of the framework, composing with tensor ("model") and
data parallelism: a (pipe, data, model) mesh where

- every stacked per-layer tensor — weights AND the KV cache — is sharded
  along its layer axis over ``pipe`` (each stage owns num_layers/P layers,
  in addition to its TP column/row shards);
- activations flow stage-to-stage with ``lax.ppermute``;
- embeddings/final-norm/lm_head are replicated; the last stage's logits
  are broadcast back with a masked ``psum``.

Execution model: sequential stage ticks (microbatch-free). Under SPMD
every rank executes each tick, but only the rank whose turn it is carries
real activations — cache writes are gated (``write_gate``) so garbage
ticks never touch state. This gives exact parity with the single-device
forward; the latency profile is P sequential stages per token (the
standard shape of pipeline-parallel *decode* — a single token's stages
are inherently sequential; throughput overlap across decode steps /
requests is the continuous-batching extension).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from llm_inference_engine.config import EngineConfig, ModelConfig
from llm_inference_engine.models import llama as llama_model
from llm_inference_engine.ops.embedding import embedding_lookup
from llm_inference_engine.ops.kv_cache import KVCache
from llm_inference_engine.ops.quant import QuantizedTensor
from llm_inference_engine.ops.rmsnorm import rmsnorm
from llm_inference_engine.parallel import sharding as S
from llm_inference_engine.parallel.mesh import DATA_AXIS, MODEL_AXIS

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = ["PIPE_AXIS", "make_pp_mesh", "pp_param_pspecs", "pp_cache_pspecs",
           "shard_params_pp", "shard_cache_pp", "make_pp_forward"]

PIPE_AXIS = "pipe"


def make_pp_mesh(pp: int = 1, dp: int = 1, tp: int = 1,
                 devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    n = pp * dp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices for pp={pp} dp={dp} tp={tp}, "
                         f"have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(pp, dp, tp)
    return Mesh(arr, (PIPE_AXIS, DATA_AXIS, MODEL_AXIS))


def _add_pipe(spec):
    """Prefix a PartitionSpec's leading (layer) axis with the pipe axis."""
    if isinstance(spec, QuantizedTensor):
        return QuantizedTensor(q=_add_pipe(spec.q), scale=_add_pipe(spec.scale),
                               mode=spec.mode, group_size=spec.group_size)
    return P(PIPE_AXIS, *tuple(spec)[1:])


def pp_param_pspecs(params) -> dict:
    """TP specs with every per-layer tensor's L axis sharded over pipe."""
    base = S.param_pspecs(params)
    return {
        "embed": base["embed"],
        "layers": {k: _add_pipe(v) for k, v in base["layers"].items()},
        "final_norm": base["final_norm"],
        "lm_head": base["lm_head"],
    }


def pp_cache_pspecs(quantized: bool = False) -> KVCache:
    base = S.cache_pspecs(quantized)

    def pipe(spec):
        return None if spec is None else P(PIPE_AXIS, *tuple(spec)[1:])

    return KVCache(k=pipe(base.k), v=pipe(base.v), lengths=base.lengths,
                   k_scale=pipe(base.k_scale), v_scale=pipe(base.v_scale),
                   embedded_scales=base.embedded_scales)


def _put(tree, specs, mesh):
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)


def shard_params_pp(params, mesh: Mesh):
    return _put(params, pp_param_pspecs(params), mesh)


def shard_cache_pp(cache: KVCache, mesh: Mesh) -> KVCache:
    return _put(cache, pp_cache_pspecs(cache.quantized), mesh)


def make_pp_forward(config: ModelConfig, engine_config: EngineConfig,
                    mesh: Mesh, params_example):
    """forward_hidden over a (pipe, data, model) mesh. Same signature as
    models.llama.forward_hidden (global shapes in/out)."""
    pp = mesh.shape[PIPE_AXIS]
    tp = mesh.shape[MODEL_AXIS]
    if config.num_layers % pp:
        raise ValueError(f"num_layers {config.num_layers} % pp {pp}")
    cfg_local = config.replace(
        num_heads=config.num_heads // tp,
        num_kv_heads=config.num_kv_heads // tp,
    )
    eng = engine_config
    model_axis = MODEL_AXIS if tp > 1 else None

    p_specs = pp_param_pspecs(params_example)
    c_specs = pp_cache_pspecs(
        quantized=engine_config.kv_cache_dtype is not None)

    def local_fwd(params, cache, token_ids, q_start, kv_len):
        rank = jax.lax.axis_index(PIPE_AXIS)
        B, T = token_ids.shape
        positions = q_start[:, None] + jnp.arange(T, dtype=jnp.int32)[None, :]
        x = embedding_lookup(params["embed"], token_ids).astype(
            cfg_local.dtype)

        perm = [(i, (i + 1) % pp) for i in range(pp)]
        for t in range(pp):
            gate = rank == t
            x_stage, cache = llama_model.run_layers(
                cfg_local, eng, params["layers"], x, cache, positions,
                q_start, kv_len, model_axis=model_axis, write_gate=gate)
            x = jnp.where(gate, x_stage, x)
            # hand the stage output to the next rank (the final stage's
            # output lands back on rank 0)
            x = jax.lax.ppermute(x, PIPE_AXIS, perm)

        cache = dataclasses.replace(cache, lengths=kv_len)
        x = rmsnorm(x, params["final_norm"], cfg_local.rms_norm_eps)
        last_idx = jnp.clip(kv_len - q_start - 1, 0, T - 1)
        hidden_last = jnp.take_along_axis(
            x, last_idx[:, None, None], axis=1)[:, 0]
        logits = llama_model.lm_head_logits(cfg_local, eng, params,
                                            hidden_last)
        if tp > 1:
            logits = jax.lax.all_gather(logits, MODEL_AXIS, axis=1,
                                        tiled=True)
        # only rank 0 holds the real logits; broadcast over the pipe axis
        logits = jax.lax.psum(
            jnp.where(rank == 0, logits, jnp.zeros_like(logits)), PIPE_AXIS)
        return logits, cache

    fwd = shard_map(
        local_fwd, mesh=mesh,
        in_specs=(p_specs, c_specs, P(DATA_AXIS, None), P(DATA_AXIS),
                  P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS, None), c_specs),
        check_vma=False,
    )
    return fwd
