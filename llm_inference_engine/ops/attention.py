"""Attention of new queries over a static KV cache, GQA-native.

One op replaces the reference's entire attention compute chain:

- prefill: q@K^T batched GEMM -> fused scale+mask+softmax -> P@V batched GEMM
  (reference: src/layers/context_attention.cpp:240-272 calling
  src/kernels/scale_and_mask_and_softmax.cu:213-341), including the GQA
  ``repeat_kv`` densification (src/kernels/repeat_kv.cu:51-106) and the
  materialized [bs, max_q, max_k] causal mask
  (src/kernels/build_causal_mask.cu:25-42);
- decode: the fused masked multi-head attention over the cache
  (reference: src/kernels/decoder_self_attention.cu:211-270) — the Sq=1
  case of the same op.

``attention`` is the production path. Prefill chunks (more than one query
row) on the GPU run cuDNN's fused attention through
``jax.nn.dot_product_attention``, with the rows below and the per-sequence
mask as here; everything else is plain XLA:

- it reads only the first ``kv_hi`` rows of each sequence (a static bound
  the engine buckets), so bytes grow with the context in use, not with
  ``max_seq_len``;
- the two dots take the storage dtype's operands (bf16; an int8 cache
  converts exactly to bf16) and accumulate in f32;
- GQA stays native: queries reshape to [K, G] groups, keys and values are
  never repeated;
- int8 scales never touch the kv stream: k-scales multiply the scores and
  v-scales the softmax weights (both constant along D).

Per-sequence ``q_start``/``kv_len`` drive the causal/length/window mask.
Rows with zero valid keys yield 0, not NaN (the reference's softmax would
NaN on an empty row).

``attention_ref`` is the float32 reference at "highest" matmul precision
over the whole cache; only tests and chip checks use it.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from llm_inference_engine.ops.kv_cache import (EMBED_PAD,
                                               decode_embedded_scales)
from llm_inference_engine.utils import cdiv

__all__ = ["attention", "attention_ref"]

_NEG_INF = -1e30


def _valid_mask(q_start, kv_len, T: int, S: int, causal: bool,
                window: int | None):
    """[B, T, S] bool: key j visible to query row i of sequence b."""
    q_pos = q_start[:, None] + jnp.arange(T)[None, :]          # [B, T]
    j = jnp.arange(S)[None, None, :]                            # [1, 1, S]
    valid = j < kv_len[:, None, None]                           # [B, 1, S]
    if causal:
        valid = valid & (j <= q_pos[:, :, None])
        if window is not None:
            # sliding window: key j visible to query p iff p-W < j <= p
            valid = valid & (j > q_pos[:, :, None] - window)
    return jnp.broadcast_to(valid, (q_start.shape[0], T, S))


def _split_embedded(k, v):
    """Embedded-scale int8 rows [B, S, K+pad, D] -> values [B, S, K, D]
    and f32 scales [B, S, K]."""
    K = k.shape[2] - EMBED_PAD
    ks = decode_embedded_scales(k[:, :, K, :], K)
    vs = decode_embedded_scales(v[:, :, K, :], K)
    return k[:, :, :K, :], v[:, :, :K, :], ks, vs


def attention_ref(q, k_cache, v_cache, q_start, kv_len, *,
                  causal: bool = True, sm_scale: float | None = None,
                  k_scale=None, v_scale=None, layer=None,
                  embedded_kv: bool = False, window: int | None = None,
                  table=None):
    """Dense-masked f32 attention (reference; O(Sq*Skv) memory).

    q:       [B, Sq, H, D]
    k_cache: [B, Skv, K, D], v_cache: same (int8 when k_scale/v_scale given:
             per-token dequant scales [B, Skv, K]); with ``layer`` given,
             a stacked [L, B, Skv, K, D] cache indexed at that layer; with
             ``table`` [B, max_pages] given, a paged pool
             [(L,) P, page, K, D] (ops/paged_kv.py)
    q_start: [B] int32 absolute position of q[:, 0]
    kv_len:  [B] int32 valid kv length (history + new tokens)
    returns  [B, Sq, H, D]
    """
    if table is not None:
        kl, vl = k_cache, v_cache
        if layer is not None:
            kl, vl = kl[layer], vl[layer]
        B, MP = table.shape
        k_cache = kl[table].reshape(B, MP * kl.shape[1], *kl.shape[2:])
        v_cache = vl[table].reshape(B, MP * vl.shape[1], *vl.shape[2:])
    elif layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    B, Sq, H, D = q.shape
    if embedded_kv:
        k_cache, v_cache, k_scale, v_scale = _split_embedded(k_cache,
                                                             v_cache)
    Skv, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    hp = jax.lax.Precision.HIGHEST

    qf = q.astype(jnp.float32).reshape(B, Sq, K, G, D)
    kf = k_cache.astype(jnp.float32)
    vf = v_cache.astype(jnp.float32)
    if k_scale is not None:
        kf = kf * k_scale[..., None]
    if v_scale is not None:
        vf = vf * v_scale[..., None]

    # logits [B, K, G, Sq, Skv]
    s = jnp.einsum("bikgd,btkd->bkgit", qf, kf, precision=hp) * scale
    valid = _valid_mask(q_start, kv_len, Sq, Skv, causal, window)
    s = jnp.where(valid[:, None, None, :, :], s, _NEG_INF)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp(s - m)
    p = jnp.where(valid[:, None, None, :, :], p, 0.0)
    l = jnp.sum(p, axis=-1, keepdims=True)
    p = p / jnp.where(l == 0.0, 1.0, l)
    out = jnp.einsum("bkgit,btkd->bikgd", p, vf, precision=hp)
    return out.reshape(B, Sq, H, D).astype(q.dtype)


def _kv_rows(k_cache, v_cache, k_scale, v_scale, layer, kv_hi, table):
    """The rows attention may read: [B, S', Kst, D] keys/values (and
    [B, S', K] scale planes), S' = the static bound ``kv_hi`` (whole pages
    for a paged pool). Only those rows are read from the cache."""
    if table is not None:
        if k_scale is not None:
            raise NotImplementedError(
                "paged cache + separate k/v scale planes: quantized paged "
                "pools use embedded scales (embedded_kv=True)")
        page = k_cache.shape[-3]
        n = table.shape[1] if kv_hi is None else min(table.shape[1],
                                                     cdiv(kv_hi, page))
        tbl = table[:, :n]
        if layer is None:
            k, v = k_cache[tbl], v_cache[tbl]
        else:                                     # one gather per side
            k, v = k_cache[layer, tbl], v_cache[layer, tbl]
        B = tbl.shape[0]
        return (k.reshape(B, n * page, *k.shape[3:]),
                v.reshape(B, n * page, *v.shape[3:]), None, None)

    lead = 0 if layer is None else 1
    S = k_cache.shape[lead + 1]
    rows = S if kv_hi is None else min(S, kv_hi)

    def take(a):
        if a is None:
            return None
        if layer is None:
            return a[:, :rows]
        start = (layer,) + (0,) * (a.ndim - 1)
        size = (1, a.shape[1], rows) + a.shape[3:]
        return jax.lax.dynamic_slice(a, start, size)[0]

    return take(k_cache), take(v_cache), take(k_scale), take(v_scale)


def _use_cudnn(q) -> bool:
    """Prefill chunks on the GPU with a 16-bit query run cuDNN's fused
    attention (measured on the card: PERF.md, Findings)."""
    return (q.dtype in (jnp.bfloat16, jnp.float16)
            and jax.default_backend() == "gpu")


def _prefill_cudnn(q, k, v, ks, vs, q_start, kv_len, causal, scale,
                   window):
    """cuDNN fused attention (``jax.nn.dot_product_attention``) over the
    rows read by ``_kv_rows``. Per-sequence ``q_start``/``kv_len`` and the
    window are a boolean mask; int8 rows are dequantized to the query
    dtype first."""
    if ks is not None:
        k = k.astype(jnp.float32) * ks[..., None]
        v = v.astype(jnp.float32) * vs[..., None]
    mask = _valid_mask(q_start, kv_len, q.shape[1], k.shape[1], causal,
                       window)
    out = jax.nn.dot_product_attention(
        q, k.astype(q.dtype), v.astype(q.dtype), mask=mask[:, None],
        scale=scale, implementation="cudnn")
    # rows with no valid key (padding past kv_len) are 0, as below
    return jnp.where(mask.any(-1)[..., None, None], out, 0).astype(q.dtype)


def attention(q, k_cache, v_cache, q_start, kv_len, *, causal: bool = True,
              sm_scale: float | None = None, k_scale=None, v_scale=None,
              layer=None, kv_hi: int | None = None,
              embedded_kv: bool = False, window: int | None = None,
              table=None):
    """Attention of q against the (already updated) KV cache.

    See attention_ref for shapes (token-major [.., Skv, K, D] cache).
    ``k_cache``/``v_cache`` must already contain the current tokens' K/V at
    positions [q_start, q_start+len) — cache write happens first
    (ops/kv_cache.py), exactly as the reference decode kernel writes the new
    k,v before attending (decoder_self_attention.cu:126,172). Pass
    ``k_scale``/``v_scale`` ([.., Skv, K] f32) for an INT8-quantized cache,
    ``layer`` (traced int32) for a stacked [L, ...] cache, ``table`` for a
    paged pool, and ``kv_hi`` (static, >= every kv_len) to bound the rows
    read.
    """
    k, v, ks, vs = _kv_rows(k_cache, v_cache, k_scale, v_scale, layer,
                            kv_hi, table)
    if embedded_kv:
        k, v, ks, vs = _split_embedded(k, v)
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    cdt = q.dtype
    if T > 1 and _use_cudnn(q):
        return _prefill_cudnn(q, k, v, ks, vs, q_start, kv_len, causal,
                              scale, window)

    qr = q.reshape(B, T, K, G, D)
    s = jnp.einsum("btkgd,bskd->bkgts", qr, k.astype(cdt),
                   preferred_element_type=jnp.float32) * scale
    if ks is not None:                        # k dequant on the scores
        s = s * jnp.swapaxes(ks, 1, 2)[:, :, None, None, :]
    valid = _valid_mask(q_start, kv_len, T, S, causal, window)
    valid = valid[:, None, None, :, :]        # [B, 1, 1, T, S]
    s = jnp.where(valid, s, _NEG_INF)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.where(valid, jnp.exp(s - m), 0.0)
    l = jnp.sum(p, axis=-1)                   # [B, K, G, T]
    if vs is not None:                        # v dequant on the weights
        p = p * jnp.swapaxes(vs, 1, 2)[:, :, None, None, :]
    out = jnp.einsum("bkgts,bskd->btkgd", p.astype(cdt), v.astype(cdt),
                     preferred_element_type=jnp.float32)
    l = jnp.transpose(l, (0, 3, 1, 2))[..., None]              # [B,T,K,G,1]
    out = out / jnp.where(l == 0.0, 1.0, l)
    return out.reshape(B, T, H, D).astype(q.dtype)
