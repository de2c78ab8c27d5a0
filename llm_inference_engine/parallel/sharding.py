"""Partition specs + shard_map-wrapped forward (tensor/data parallelism).

The scaling design the reference never had (SURVEY.md §2f): Megatron-style
TP expressed with shard_map — params/cache laid out so every shard owns
whole KV groups, the layer body runs on local shards inside ``shard_map``,
and the only cross-device traffic is one ``psum`` after the attention
output projection and one after the FFN down projection, plus an
``all_gather`` of the vocab-sharded logits. The ops run unchanged on the
local shapes.

Sharding map (weights [in, out] convention):
- wqkv  [L, H, K*(G+2)*D]  -> (None, None, "model")   column/group-sharded
- wo    [L, H*D_q, H]      -> (None, "model", None)   row-sharded -> psum
- w_gate_up [L, H, 2, I]   -> (None, None, None, "model")
- w_down    [L, I, H]      -> (None, "model", None)   row-sharded -> psum
- lm_head   [H, V]         -> (None, "model")         vocab-sharded -> gather
- norms/embed              -> replicated
- cache k/v [L, B, K, S, D]-> (None, "data", "model", None, None)

Paged layout (ops/paged_kv.py) composes with the same rules: the page
pool [L, P, page, Kst, D] shards its kv-head axis over "model" (every
shard holds its heads of EVERY page, so one global block table serves all
shards) and stays un-sharded over "data" — each data group's devices
write only the pages its own slots allocated (the host allocator hands
disjoint pages to disjoint slots), so pool replicas diverge ONLY in pages
the other groups own, which this group's block-table rows never
reference. Block-table rows and lengths shard over "data" like the slot
cache's batch axis. Embedded-scale (int8) pools do NOT shard: the scale
rows ride the kv-head axis (kv_cache.EMBED_PAD) and splitting them would
separate scales from their heads — the engine guards that combination.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from llm_inference_engine.config import EngineConfig, ModelConfig
from llm_inference_engine.models import llama as llama_model
from llm_inference_engine.ops.kv_cache import KVCache
from llm_inference_engine.ops.quant import QuantizedTensor
from llm_inference_engine.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, local_config, validate_mesh)

try:  # moved out of experimental in newer jax
    from jax import shard_map  # type: ignore[attr-defined]
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = [
    "param_pspecs",
    "cache_pspecs",
    "shard_params",
    "shard_cache",
    "make_sharded_forward",
]


def _qkv_spec(leading_l: bool):
    lead = (None,) if leading_l else ()
    return P(*lead, None, MODEL_AXIS)


def param_pspecs(params) -> dict:
    """PartitionSpec pytree matching the params structure (quantized leaves
    get specs on both q and scale)."""

    def spec_of(name: str, leading_l: bool):
        lead = (None,) if leading_l else ()
        table = {
            "wqkv": P(*lead, None, MODEL_AXIS),
            "bqkv": P(*lead, MODEL_AXIS),     # follows wqkv's out sharding
            "wo": P(*lead, MODEL_AXIS, None),
            "w_gate_up": P(*lead, None, None, MODEL_AXIS),
            "w_down": P(*lead, MODEL_AXIS, None),
            "attn_norm": P(*lead, None),
            "ffn_norm": P(*lead, None),
        }
        return table[name]

    def quant_spec(name: str, t: QuantizedTensor, leading_l: bool):
        # int8 scale [.., 1, out] / int4 scale [.., groups, out] follow the
        # out/in sharding of q
        lead = (None,) if leading_l else ()
        if name == "w_gate_up":                  # column-sharded, [.., 2, I]
            q = P(*lead, None, None, MODEL_AXIS)
            s = P(*lead, None, None, MODEL_AXIS)
        elif name == "wqkv":                     # column-sharded (group-major)
            q = P(*lead, None, MODEL_AXIS)
            s = P(*lead, None, MODEL_AXIS)
        else:                                    # row-sharded
            q = P(*lead, MODEL_AXIS, None)
            # int8 scale rows don't shard (scale is per-out-channel);
            # int4 grouped scales shard along the contraction groups
            s = P(*lead, MODEL_AXIS, None) if t.mode == "int4" else P(*lead, None, None)
        return QuantizedTensor(q=q, scale=s, mode=t.mode,
                               group_size=t.group_size)

    layer_specs = {}
    for name, w in params["layers"].items():
        if isinstance(w, QuantizedTensor):
            layer_specs[name] = quant_spec(name, w, True)
        else:
            layer_specs[name] = spec_of(name, True)

    lm = params["lm_head"]
    if isinstance(lm, QuantizedTensor):
        lm_spec = QuantizedTensor(q=P(None, MODEL_AXIS),
                                  scale=P(None, MODEL_AXIS), mode=lm.mode,
                                  group_size=lm.group_size)
    else:
        lm_spec = P(None, MODEL_AXIS)

    return {
        "embed": P(None, None),
        "layers": layer_specs,
        "final_norm": P(None),
        "lm_head": lm_spec,
    }


def cache_pspecs(quantized: bool = False, embedded: bool = False) -> KVCache:
    # token-major cache [L, B, S, K, D]: batch over data, kv heads over
    # model. Padded and embedded-scale layouts shard the SAME way because
    # the cache is allocated with per-shard groups on the head axis
    # (kv_cache.new_kv_cache shard_groups): pad rows and scale rows stay
    # with their shard's heads.
    kv = P(None, DATA_AXIS, None, MODEL_AXIS, None)
    sc = (P(None, DATA_AXIS, None, MODEL_AXIS)
          if quantized and not embedded else None)
    return KVCache(k=kv, v=kv, lengths=P(DATA_AXIS), k_scale=sc, v_scale=sc,
                   embedded_scales=embedded)


def paged_cache_pspecs(cache) -> "PagedKVCache":
    """Paged pool [L, P, page, Kst, D]: kv heads over model, pages NOT
    sharded over data (see module docstring for why the per-data-group
    divergence in unreferenced pages is sound); table/lengths rows over
    data."""
    from llm_inference_engine.ops.paged_kv import PagedKVCache
    if cache.embedded_scales:
        raise NotImplementedError(
            "embedded-scale (int8) paged pools do not shard: the scale "
            "rows ride the kv-head axis")
    kv = P(None, None, None, MODEL_AXIS, None)
    return PagedKVCache(k=kv, v=kv, block_table=P(DATA_AXIS, None),
                        lengths=P(DATA_AXIS),
                        embedded_scales=cache.embedded_scales)


def _put(tree, specs, mesh: Mesh):
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)


def shard_params(params, mesh: Mesh):
    return _put(params, param_pspecs(params), mesh)


def shard_cache(cache, mesh: Mesh):
    from llm_inference_engine.ops.paged_kv import PagedKVCache
    specs = (paged_cache_pspecs(cache) if isinstance(cache, PagedKVCache)
             else cache_pspecs(cache.quantized, cache.embedded_scales))
    return _put(cache, specs, mesh)


def make_sharded_forward(config: ModelConfig, engine_config: EngineConfig,
                         mesh: Mesh, params_example, cache_example=None):
    """Build forward_hidden over the mesh: local compute via shard_map with
    explicit psum/all_gather collectives; returns a function with the same
    signature as models.llama.forward_hidden (global shapes in/out).
    ``cache_example``: pass the engine's cache to pick the matching specs
    (slot vs paged layout); None keeps the slot-layout default."""
    from llm_inference_engine.ops.paged_kv import PagedKVCache
    validate_mesh(config, engine_config, mesh)
    cfg_local = local_config(config, mesh)
    tp = mesh.shape[MODEL_AXIS]

    p_specs = param_pspecs(params_example)
    if isinstance(cache_example, PagedKVCache):
        c_specs = paged_cache_pspecs(cache_example)
    elif cache_example is not None:
        c_specs = cache_pspecs(cache_example.quantized,
                               cache_example.embedded_scales)
    else:
        c_specs = cache_pspecs(
            quantized=engine_config.kv_cache_dtype is not None)

    def local_fwd(params, cache, token_ids, q_start, kv_len):
        # runs per-shard: token_ids [B_loc, T], params local columns/rows
        hidden, new_cache = llama_model.decoder_forward(
            cfg_local, engine_config, params, token_ids, cache, q_start,
            kv_len, model_axis=MODEL_AXIS if tp > 1 else None)
        B, T, _ = hidden.shape
        last_idx = jnp.clip(kv_len - q_start - 1, 0, T - 1)
        hidden_last = jnp.take_along_axis(
            hidden, last_idx[:, None, None], axis=1)[:, 0]
        logits = llama_model.lm_head_logits(
            cfg_local, engine_config, params, hidden_last)       # [B_loc, V/tp]
        if tp > 1:
            logits = jax.lax.all_gather(
                logits, MODEL_AXIS, axis=1, tiled=True)          # [B_loc, V]
        return logits, new_cache

    fwd = shard_map(
        local_fwd, mesh=mesh,
        in_specs=(p_specs, c_specs, P(DATA_AXIS, None), P(DATA_AXIS),
                  P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS, None), c_specs),
        check_vma=False,
    )
    return fwd
