"""Functional Llama-class decoder forward pass.

Capability parity with the reference's layer/model compute tier:
- the per-layer sandwich rmsnorm -> attention -> add+rmsnorm -> ffn -> add
  (reference: src/layers/includes/context_decoder.h,
  context_decoder.cpp:127-190 and self_decoder.cpp:69-119);
- prefill vs decode as the same dataflow at different query lengths
  (reference splits them into LlamaContextAttentionLayer /
  LlamaSelfAttentionLayer + two decoder classes; here one function serves
  both — the attention kernel is length-agnostic);
- LM head on the last valid token only (reference: llama.cpp:260-318
  slices the final token before the lm_head GEMM).

The 32-layer loop is a single ``lax.scan`` (one compiled layer body — the
reference re-launched ~15 kernels per layer per step). Only small per-layer
tensors (norm gains, unquantized weights) ride the scan xs; the two
multi-GB structures — quantized weights and the KV cache — stay WHOLE and
are indexed by the traced layer index inside the layer, so the cache rides
the carry and is updated in place rather than sliced out and stacked back
every step.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from llm_inference_engine.config import EngineConfig, ModelConfig
from llm_inference_engine.ops import kv_cache as kvc
from llm_inference_engine.ops.activations import silu_and_mul, add_residual
from llm_inference_engine.ops.attention import attention
from llm_inference_engine.ops.embedding import embedding_lookup
from llm_inference_engine.ops.linear import linear
from llm_inference_engine.ops.rmsnorm import rmsnorm, add_residual_rmsnorm
from llm_inference_engine.ops.rope import split_qkv_rope
from llm_inference_engine.utils import debug as _debug

__all__ = ["decoder_forward", "forward_hidden", "lm_head_logits"]


def _layer_step(cfg: ModelConfig, eng: EngineConfig, x, layer, layer_idx,
                cache: kvc.KVCache, positions, q_start, kv_len,
                model_axis=None, kv_hi=None, cp=None):
    """One decoder layer. x: [B, T, H]; cache holds the full stacked
    [L, B, K, S, D] arrays — this layer reads/writes slice ``layer_idx``.

    Kernel sequence mirrors the reference contract
    (context_attention.cpp:144-304, ffn.cpp:77-140, self_decoder.cpp:69-119).

    Cache dataflow is the hot design point: the write scatters each
    sequence's valid new rows (at most T) into the 5-D array (in place
    under donation) and attention reads the layer's rows up to ``kv_hi``
    straight out of the full array.

    Under tensor parallelism (``model_axis`` set, used inside shard_map) the
    row-sharded o/down projections produce partial sums reduced with one
    psum each — the two all-reduces per layer of Megatron-style TP.
    """
    B, T, _ = x.shape
    stacked = layer.get("__stacked__", {})

    def reduce_partial(y):
        if model_axis is None:
            return y
        return jax.lax.psum(y, model_axis)

    def lin(name, inp):
        """Matmul against weight ``name``: stacked quantized weights stay
        whole and are indexed by layer inside the matmul; everything else
        arrives already layer-sliced by the scan."""
        if name in stacked:
            return linear(inp, stacked[name], layer=layer_idx)
        return linear(inp, layer[name])

    # intermediate dumping at the reference's SAVE_DATA points
    # (context_attention.cpp:193-304); a trace-time no-op unless enabled
    # (LLM_ENGINE_SAVE_DATA). Host callbacks don't compose with shard_map
    # collectives, so TP and CP runs skip the taps.
    if _debug.tap.enabled and model_axis is None and cp is None:
        def dump(name, value):
            _debug.tap(name, value, layer=layer_idx)
    else:
        def dump(name, value):
            pass

    # pre-attention rmsnorm (residual = x itself; the reference's rmsnorm
    # copies input to a residual buffer, rmsnorm.cu:55 — functionally free here)
    h_norm = rmsnorm(x, layer["attn_norm"], cfg.rms_norm_eps)
    dump("attn_norm", h_norm)

    # fused QKV projection (packed, layer_weights.cpp:28); Qwen2-class
    # models add the packed qkv bias here (the reference's QKV+RoPE kernel
    # accepted a bias it never used for Llama, qkv_bias_and_rope.cu:97 —
    # XLA fuses the add into the matmul epilogue)
    qkv = lin("wqkv", h_norm)
    if "bqkv" in layer:
        qkv = qkv + layer["bqkv"].astype(qkv.dtype)
    dump("qkv_proj", qkv)
    q, k_new, v_new = split_qkv_rope(
        qkv, positions, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        cfg.rope_theta, cfg.rope_scaling)
    dump("q_rope", q)
    dump("k_rope", k_new)

    # Tile-padded cache adapter (ops/kv_cache.aligned_kv_dims): when the
    # cache was allocated with K/D rounded up to the (8, 128) tile, zero-pad
    # the new tokens and queries to match. Zero D-columns leave q·k dots
    # exact; padded kv heads compute garbage that is sliced away below.
    K, D = k_new.shape[2], k_new.shape[3]
    Kc, Dc = cache.num_kv_heads, cache.k.shape[-1]
    padded = (Kc, Dc) != (K, D)
    sm_scale = 1.0 / math.sqrt(D)  # real head_dim even under padding
    if padded:
        G = q.shape[2] // K
        q = jnp.pad(q.reshape(B, T, K, G, D),
                    ((0, 0), (0, 0), (0, Kc - K), (0, 0), (0, Dc - D))
                    ).reshape(B, T, Kc * G, Dc)
        pad4 = ((0, 0), (0, 0), (0, Kc - K), (0, Dc - D))
        k_new = jnp.pad(k_new, pad4)
        v_new = jnp.pad(v_new, pad4)

    from llm_inference_engine.ops.paged_kv import (
        PagedKVCache, paged_update_at_layer)
    from llm_inference_engine.parallel.cp_cache import (
        CPCache, cp_write_plan)
    if isinstance(cache, CPCache):
        # context-parallel append-log cache (parallel/cp_cache.py): this
        # rank writes its sub-chunk into its LOCAL log (never cross-rank),
        # then attention runs over the seq axis — ring for prefill,
        # split-KV (flash-decoding) for decode. Masks come from the
        # absolute positions in cache.kv_pos, so log order is irrelevant.
        from llm_inference_engine.parallel.context_parallel import (
            ring_attention, split_kv_decode_attention)
        assert cp is not None, "CPCache requires a CPSpec (cp_engine)"
        me = jax.lax.axis_index(cp.axis)
        start, count, _ = cp_write_plan(cache.llen, q_start, kv_len, me,
                                        cp.n, T)
        tmp = kvc.KVCache(k=cache.k, v=cache.v, lengths=cache.lengths,
                          k_scale=cache.k_scale, v_scale=cache.v_scale,
                          embedded_scales=cache.embedded_scales)
        tmp = kvc.update_cache_at_layer(tmp, layer_idx, k_new, v_new, start,
                                        new_len=count)
        cache = dataclasses.replace(cache, k=tmp.k, v=tmp.v,
                                    k_scale=tmp.k_scale, v_scale=tmp.v_scale)
        # rows valid after this layer's write: the local log tail moved by
        # ``count`` (kv_pos was already appended by the cp_engine wrapper)
        s_local = cache.k.shape[2]
        kv_hi_l = min(s_local, kv_hi) if kv_hi else s_local

        def _layer_rows(arr):
            return (None if arr is None else jax.lax.dynamic_index_in_dim(
                arr, layer_idx, 0, keepdims=False)[:, :kv_hi_l])

        k_loc, v_loc = _layer_rows(cache.k), _layer_rows(cache.v)
        ks_loc, vs_loc = (_layer_rows(cache.k_scale),
                          _layer_rows(cache.v_scale))
        kv_pos = cache.kv_pos[:, :kv_hi_l]
        llen_me = cache.llen[:, me] + count
        kv_valid = (jnp.arange(kv_hi_l, dtype=jnp.int32)[None, :]
                    < llen_me[:, None])
        if T == 1:
            attn_out = split_kv_decode_attention(
                q, k_loc, v_loc, positions, kv_pos, kv_valid, cp.axis,
                sm_scale=sm_scale, window=cfg.sliding_window,
                out_dtype=x.dtype, k_scale=ks_loc, v_scale=vs_loc,
                embedded_kv=cache.embedded_scales)
        else:
            attn_out = ring_attention(
                q, k_loc, v_loc, positions, kv_pos, kv_valid, cp.axis,
                cp.n, sm_scale=sm_scale, causal=True,
                window=cfg.sliding_window, out_dtype=x.dtype,
                k_scale=ks_loc, v_scale=vs_loc,
                embedded_kv=cache.embedded_scales)
    elif isinstance(cache, PagedKVCache):
        # paged path: block-table writes + table-indirected attention
        # (ops/paged_kv.py)
        cache = paged_update_at_layer(cache, layer_idx, k_new, v_new,
                                      q_start, new_len=kv_len - q_start)
        attn_out = attention(q, cache.k, cache.v, q_start, kv_len,
                             causal=True, sm_scale=sm_scale,
                             layer=layer_idx, kv_hi=kv_hi,
                             embedded_kv=cache.embedded_scales,
                             window=cfg.sliding_window,
                             table=cache.block_table)
    else:
        # write before attend (decoder_self_attention.cu:126,172 semantics)
        cache = kvc.update_cache_at_layer(cache, layer_idx, k_new, v_new,
                                          q_start, new_len=kv_len - q_start)
        attn_out = attention(q, cache.k, cache.v, q_start, kv_len,
                             causal=True, sm_scale=sm_scale,
                             k_scale=cache.k_scale, v_scale=cache.v_scale,
                             layer=layer_idx, kv_hi=kv_hi,
                             embedded_kv=cache.embedded_scales,
                             window=cfg.sliding_window)
    if padded:
        attn_out = attn_out.reshape(B, T, Kc, G, Dc)[:, :, :K, :, :D]
    attn_out = attn_out.reshape(B, T, cfg.q_size)
    dump("attn_ctx", attn_out)
    attn_out = reduce_partial(lin("wo", attn_out))
    dump("attn_out", attn_out)

    # fused add-residual + rmsnorm into the FFN (add_residual_and_rmsnorm.cu)
    ffn_in, resid = add_residual_rmsnorm(
        attn_out, x, layer["ffn_norm"], cfg.rms_norm_eps)
    dump("ffn_in", ffn_in)

    # FFN: packed gate|up matmul -> SwiGLU -> down (ffn.cpp:105-132)
    gate_up = lin("w_gate_up", ffn_in)
    act = silu_and_mul(gate_up)
    dump("ffn_act", act)
    down = reduce_partial(lin("w_down", act))

    x_out = add_residual(down, resid)
    dump("layer_out", x_out)
    return x_out, cache


def run_layers(cfg: ModelConfig, eng: EngineConfig, layers_params, x,
               cache: kvc.KVCache, positions, q_start, kv_len,
               model_axis=None, kv_hi=None, write_gate=None, cp=None):
    """The decoder layer loop: one ``lax.scan`` over stacked layer weights
    with the cache riding the carry (whole, never sliced per layer).
    ``layers_params`` holds as many layers as ``cache`` does — under
    pipeline parallelism that is this stage's local slice.

    ``write_gate`` (traced bool, used by the pipeline-parallel driver):
    when False, cache writes are skipped entirely — an SPMD pipeline stage
    runs every tick but only its own tick carries real activations.
    """
    num_layers = cache.num_layers

    # quantized stacked weights never enter the scan xs: they are closed
    # over whole and indexed by layer inside the matmul (ops/quant.py)
    from llm_inference_engine.ops.quant import QuantizedTensor
    xs_layers = {k: v for k, v in layers_params.items()
                 if not isinstance(v, QuantizedTensor)}
    stacked = {k: v for k, v in layers_params.items()
               if isinstance(v, QuantizedTensor)}

    def step(x_carry, cache, layer, layer_idx):
        layer = dict(layer)
        layer["__stacked__"] = stacked
        return _layer_step(
            cfg, eng, x_carry, layer, layer_idx, cache, positions,
            q_start, kv_len, model_axis=model_axis, kv_hi=kv_hi, cp=cp)

    if write_gate is None:
        def body(carry, xs):
            x_carry, cache = carry
            layer, layer_idx = xs
            x_out, cache = step(x_carry, cache, layer, layer_idx)
            return (x_out, cache), None
    else:
        def body(carry, xs):
            x_carry, cache = carry
            layer, layer_idx = xs
            x_out, cache = jax.lax.cond(
                write_gate,
                lambda xc, c: step(xc, c, layer, layer_idx),
                lambda xc, c: (xc, c),
                x_carry, cache)
            return (x_out, cache), None

    unroll = max(1, getattr(eng, "layer_scan_unroll", 1))
    (x, cache), _ = jax.lax.scan(
        body, (x, cache),
        (xs_layers, jnp.arange(num_layers, dtype=jnp.int32)),
        unroll=min(unroll, num_layers))
    return x, cache


def decoder_forward(cfg: ModelConfig, eng: EngineConfig, params, token_ids,
                    cache: kvc.KVCache, q_start, kv_len, model_axis=None,
                    kv_hi=None, cp=None):
    """Run all decoder layers. Returns (hidden [B,T,H], updated KVCache).

    token_ids: [B, T] int32 (prefill: padded prompt chunk; decode: T=1)
    q_start:   [B] write/attend offset (history length per slot)
    kv_len:    [B] total valid kv after this call (q_start + actual new)
    cp:        CPSpec (parallel/cp_cache.py) when running inside shard_map
               over a ``seq`` axis: prefill chunks are computed
               sequence-sharded (this rank embeds/projects only its
               [me*T/n, (me+1)*T/n) sub-chunk; hidden comes back
               [B, T/n, H] local), decode stays replicated over seq.
    """
    B, T = token_ids.shape
    if cp is not None and T > 1:
        t_local = T // cp.n
        me = jax.lax.axis_index(cp.axis)
        token_ids = jax.lax.dynamic_slice_in_dim(
            token_ids, me * t_local, t_local, axis=1)
        positions = (q_start[:, None] + me * t_local
                     + jnp.arange(t_local, dtype=jnp.int32)[None, :])
    else:
        positions = q_start[:, None] + jnp.arange(T, dtype=jnp.int32)[None, :]

    x = embedding_lookup(params["embed"], token_ids)
    x = x.astype(cfg.dtype)
    if _debug.tap.enabled and model_axis is None and cp is None:
        _debug.tap("embedding", x)

    x, cache = run_layers(cfg, eng, params["layers"], x, cache, positions,
                          q_start, kv_len, model_axis=model_axis,
                          kv_hi=kv_hi, cp=cp)
    new_cache = dataclasses.replace(cache, lengths=kv_len)

    x = rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)
    if _debug.tap.enabled and model_axis is None and cp is None:
        _debug.tap("final_norm", x)
    return x, new_cache


def lm_head_logits(cfg: ModelConfig, eng: EngineConfig, params, hidden_last):
    """hidden_last: [B, H] -> logits [B, V] (f32)."""
    return linear(hidden_last, params["lm_head"], out_dtype=jnp.float32)


def forward_all_logits(cfg: ModelConfig, eng: EngineConfig, params,
                       token_ids, cache, q_start, kv_len, kv_hi=None):
    """decoder_forward + lm head on EVERY position -> (logits [B, T, V],
    cache). The verify step of speculative decoding and the perplexity
    scorer both need per-position logits (the reference's lm head only
    ever saw the final token, llama.cpp:264-269)."""
    hidden, cache = decoder_forward(cfg, eng, params, token_ids, cache,
                                    q_start, kv_len, kv_hi=kv_hi)
    logits = lm_head_logits(cfg, eng, params, hidden)
    return logits, cache


def forward_hidden(cfg: ModelConfig, eng: EngineConfig, params, token_ids,
                   cache, q_start, kv_len, kv_hi=None):
    """decoder_forward + last-valid-token slice -> (logits [B,V], cache).

    The last valid token of sequence b sits at padded index
    kv_len[b]-q_start[b]-1 (reference slices it at llama.cpp:264-269).
    """
    hidden, cache = decoder_forward(cfg, eng, params, token_ids, cache,
                                    q_start, kv_len, kv_hi=kv_hi)
    B, T, H = hidden.shape
    last_idx = jnp.clip(kv_len - q_start - 1, 0, T - 1)           # [B]
    hidden_last = jnp.take_along_axis(
        hidden, last_idx[:, None, None], axis=1)[:, 0]            # [B, H]
    logits = lm_head_logits(cfg, eng, params, hidden_last)
    return logits, cache
