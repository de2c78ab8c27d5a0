"""Engine wiring for context parallelism (the ``seq`` mesh axis).

``make_cp_forward`` builds a drop-in replacement for
``models.llama.forward_hidden`` that runs the whole forward inside one
``shard_map`` over a (data, seq, model) mesh:

- prefill: the token chunk is sequence-sharded — each rank embeds and
  projects only its [me*T/n, (me+1)*T/n) sub-chunk, appends the resulting
  k/v to its LOCAL cache log (parallel/cp_cache.py), and attention runs as
  ring attention over the seq axis (parallel/context_parallel.py);
- decode: activations are replicated over seq (every rank computes the
  same token's projections — decode is KV-bandwidth-bound, and the KV
  stream is what CP shards), the least-full rank appends the token, and
  attention runs as split-KV flash-decoding: local attend + pmax/psum
  combine, reading the cache at the seq axis' aggregate memory bandwidth;
- tensor parallelism composes unchanged: the same shard_map body carries
  the ``model`` axis, so the per-layer psums and the vocab all_gather ride
  it exactly as in parallel/sharding.py.

This closes SURVEY.md §5's long-context row beyond one chip: engine
sequence capacity becomes cp * (per-chip cache), selected with
``EngineConfig(cp=...)``. Reference context: the reference is single-GPU,
max_seq_len=64 (src/models/llama/llama_config.json:8) with no distributed
tier at all.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from llm_inference_engine.config import EngineConfig, ModelConfig
from llm_inference_engine.models import llama as llama_model
from llm_inference_engine.parallel.cp_cache import (
    CPCache, CPSpec, append_kv_pos, cp_llen_after, cp_write_plan)
from llm_inference_engine.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, local_config, validate_mesh)
from llm_inference_engine.parallel.sharding import param_pspecs

try:  # moved out of experimental in newer jax
    from jax import shard_map  # type: ignore[attr-defined]
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = ["cp_cache_pspecs", "make_cp_forward"]


def cp_cache_pspecs(cache: CPCache | None = None) -> CPCache:
    """Rows over seq, batch over data, kv heads over model; the tiny
    [B, n] llen stays replicated (updated in lockstep on every rank).
    Pass the cache (or any example with the same variant fields) so the
    spec tree matches structurally: int8 logs carry [L, B, S, K] scale
    planes sharded with their rows, and the embedded flag is a static
    treedef field."""
    quant = cache is not None and cache.k_scale is not None
    return CPCache(
        k=P(None, DATA_AXIS, SEQ_AXIS, MODEL_AXIS, None),
        v=P(None, DATA_AXIS, SEQ_AXIS, MODEL_AXIS, None),
        kv_pos=P(DATA_AXIS, SEQ_AXIS),
        llen=P(DATA_AXIS, None),
        lengths=P(DATA_AXIS),
        k_scale=P(None, DATA_AXIS, SEQ_AXIS, MODEL_AXIS) if quant else None,
        v_scale=P(None, DATA_AXIS, SEQ_AXIS, MODEL_AXIS) if quant else None,
        embedded_scales=(cache.embedded_scales if cache is not None
                         else False),
    )


def make_cp_forward(config: ModelConfig, engine_config: EngineConfig,
                    mesh: Mesh, params_example, cache_example=None):
    """forward_hidden over a (data, seq, model) mesh with a CPCache.

    Same signature as parallel.sharding.make_sharded_forward's result:
    (params, cache, token_ids [B, T], q_start [B], kv_len [B]) ->
    (logits [B, V], cache), global shapes in/out. ``kv_hi`` is closed over
    per-trace by the engine (static watermark), passed as the 6th arg.
    """
    validate_mesh(config, engine_config, mesh)
    cfg_local = local_config(config, mesh)
    tp = mesh.shape[MODEL_AXIS]
    n = mesh.shape[SEQ_AXIS]
    spec = CPSpec(axis=SEQ_AXIS, n=n)

    p_specs = param_pspecs(params_example)
    c_specs = cp_cache_pspecs(cache_example)

    def local_fwd(params, cache, token_ids, q_start, kv_len, kv_hi):
        B, T = token_ids.shape
        me = jax.lax.axis_index(SEQ_AXIS)
        t_local = T // n if T > 1 else 1

        # append the new rows' absolute positions to this rank's kv_pos
        # BEFORE the layer loop (identical for every layer); the layers
        # still see the OLD llen — their write offsets are the log tails
        start, count, pos0 = cp_write_plan(cache.llen, q_start, kv_len,
                                           me, n, t_local)
        cache = dataclasses.replace(
            cache,
            kv_pos=append_kv_pos(cache.kv_pos, start, count, pos0, t_local))

        hidden, cache = llama_model.decoder_forward(
            cfg_local, engine_config, params, token_ids, cache, q_start,
            kv_len, model_axis=MODEL_AXIS if tp > 1 else None,
            kv_hi=kv_hi, cp=spec)

        # the log tails advance only after every layer has used the old
        # offsets (replicated update: every rank computes the same [B, n])
        cache = dataclasses.replace(
            cache,
            llen=cp_llen_after(cache.llen, q_start, kv_len, n, t_local))

        # last-valid-token hidden: under a sharded prefill chunk the last
        # token lives on ONE rank — select it and share via psum
        if T == 1:
            hidden_last = hidden[:, 0]                          # replicated
        else:
            new = kv_len - q_start                              # [B]
            last = jnp.maximum(new - 1, 0)
            owner = last // t_local                             # [B]
            local_idx = last - owner * t_local                  # [B]
            cand = jnp.take_along_axis(
                hidden, local_idx[:, None, None], axis=1)[:, 0]  # [B, H]
            mine = ((owner == me) & (new > 0))[:, None]
            hidden_last = jax.lax.psum(
                jnp.where(mine, cand, jnp.zeros_like(cand)), SEQ_AXIS)

        logits = llama_model.lm_head_logits(
            cfg_local, engine_config, params, hidden_last)      # [B, V/tp]
        if tp > 1:
            logits = jax.lax.all_gather(
                logits, MODEL_AXIS, axis=1, tiled=True)         # [B, V]
        return logits, cache

    def run(params, cache, token_ids, q_start, kv_len, kv_hi=None):
        fwd = shard_map(
            functools.partial(local_fwd, kv_hi=kv_hi),
            mesh=mesh,
            in_specs=(p_specs, c_specs, P(DATA_AXIS, None), P(DATA_AXIS),
                      P(DATA_AXIS)),
            out_specs=(P(DATA_AXIS, None), c_specs),
            check_vma=False,
        )
        return fwd(params, cache, token_ids, q_start, kv_len)

    return run
