"""KV cache: a preallocated, donated, statically-shaped pytree.

Capability parity with the reference's cache machinery:
- allocation [layers, bs, kv_heads, max_seq, hs] held by the model
  (reference: src/models/llama/llama.cpp:47-69);
- prefill append ``launchConcatKVCache``
  (reference: src/kernels/concat_past_kv.cu:44-89 — writes the padded
  per-head k/v at history_len+token);
- the decode kernel's in-place single-token cache write
  (reference: src/kernels/decoder_self_attention.cu:126,172).

Layout: **token-major [L, B, S, K, D]** (the reference used head-major
[layers, bs, heads, seq, hs]): one sequence's rows for a layer are one
contiguous [S, K, D] span, and a write of T new tokens touches one
contiguous [T, K, D] window per (layer, sequence).

The write (``update_cache_at_layer``) is in place by construction: one
scatter puts each sequence's valid new rows at their positions and drops
the padding rows. Under donation XLA updates the buffer in place, so a
layer's write moves at most T rows per sequence, never the cache. (A
batch-vmapped dynamic_update_slice over the [L, B, ...] array is not: its
batch axis is not the leading one, and XLA transposed the whole cache
around it on every layer.)

An int8-quantized cache variant stores values with per-(token, head) scales
[L, B, S, K] f32 (quantize-on-write, dequantize-in-attention) — part of the
quantization goal the reference never reached (README.md:36-39).

No allocator is needed (the reference required a pooling CudaAllocator,
src/memory/allocator/cuda_allocator.h:23, because it malloc'd per forward;
here every buffer is preallocated and donated, SURVEY.md §2b).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from llm_inference_engine.utils import round_up

__all__ = ["KVCache", "new_kv_cache", "update_layer_cache",
           "update_cache_at_layer", "aligned_kv_dims"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KVCache:
    """k/v: [L, B, S, K, D] token-major; lengths: [B] valid tokens per slot.

    Two int8-quantized variants:
    - separate scales: k_scale/v_scale [L, B, S, K] f32 per-(token, head)
      absmax scales;
    - embedded scales (``embedded_scales``): the arrays are
      [L, B, S, K+8, D] int8 and row K of each token carries the scales as
      log2-quantized 16-bit codes (hi byte in columns [0, K), low byte in
      columns [K, 2K)), so values and scales travel in one array. Values
      are quantized against the snapped scale 2^(code/256), so
      dequantization is exact. The paged int8 pool uses this layout.
    """

    k: jax.Array
    v: jax.Array
    lengths: jax.Array
    k_scale: Optional[jax.Array] = None
    v_scale: Optional[jax.Array] = None
    embedded_scales: bool = dataclasses.field(
        metadata=dict(static=True), default=False)

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def batch_size(self) -> int:
        return self.k.shape[1]

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[2]

    @property
    def num_kv_heads(self) -> int:
        return self.k.shape[3] - (EMBED_PAD if self.embedded_scales else 0)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None or self.embedded_scales


EMBED_PAD = 8  # extra rows per token (codes in the first, rest zero)


def embedded_supported(num_kv_heads: int, head_dim: int) -> bool:
    """hi+lo scale bytes for all K heads must fit one D-wide row."""
    return 2 * num_kv_heads <= head_dim


def aligned_kv_dims(num_kv_heads: int, head_dim: int) -> tuple[int, int]:
    """(K, D) rounded up to an (8, 128) tile (``new_kv_cache``'s
    ``pad_to_tiles`` format). Production Llama shapes (D=128, K a multiple
    of 8) are already aligned; small-head models (TinyLlama: K=4, D=64)
    pad."""
    return round_up(num_kv_heads, 8), round_up(head_dim, 128)


def new_kv_cache(num_layers: int, batch_size: int, num_kv_heads: int,
                 max_seq_len: int, head_dim: int, dtype=jnp.bfloat16,
                 quantized: bool = False,
                 embedded: bool = False,
                 pad_to_tiles: bool = False,
                 shard_groups: int = 1) -> KVCache:
    """``pad_to_tiles`` pads K/D up to the (8, 128) tile — only for callers
    whose forwards go through models/llama.py, which zero-pads its
    new-token writes and queries to match and slices the attention output
    back (numerically identical, pinned by tests/test_padded_cache.py).
    ``embedded`` (with ``quantized``) selects the embedded-scale int8
    layout instead of separate scale planes.

    ``shard_groups``: allocate the head axis as that many EQUAL groups
    (the tensor-parallel shard count) with tile padding and embedded
    scale rows applied PER GROUP — so an even split over the mesh's
    model axis hands every shard a self-contained local layout
    [K/g (+pad) (+EMBED_PAD), D], identical to what a single-device
    cache of K/g heads would be. Note the ``num_kv_heads`` property is
    a LOCAL-view accessor (inside shard_map); it is not meaningful on a
    multi-group global array."""
    if num_kv_heads % shard_groups:
        raise ValueError(f"num_kv_heads {num_kv_heads} % shard_groups "
                         f"{shard_groups}")
    k_loc = num_kv_heads // shard_groups
    if pad_to_tiles:
        k_loc, head_dim = aligned_kv_dims(k_loc, head_dim)
    lengths = jnp.zeros((batch_size,), jnp.int32)
    if quantized:
        if embedded:
            if not embedded_supported(k_loc, head_dim):
                raise ValueError(f"embedded int8 scales need 2*K <= D "
                                 f"(K={k_loc}, D={head_dim})")
            shape = (num_layers, batch_size, max_seq_len,
                     shard_groups * (k_loc + EMBED_PAD), head_dim)
            return KVCache(jnp.zeros(shape, jnp.int8),
                           jnp.zeros(shape, jnp.int8), lengths,
                           embedded_scales=True)
        shape = (num_layers, batch_size, max_seq_len,
                 shard_groups * k_loc, head_dim)
        sshape = shape[:-1]
        return KVCache(jnp.zeros(shape, jnp.int8),
                       jnp.zeros(shape, jnp.int8), lengths,
                       jnp.ones(sshape, jnp.float32),
                       jnp.ones(sshape, jnp.float32))
    shape = (num_layers, batch_size, max_seq_len, shard_groups * k_loc,
             head_dim)
    return KVCache(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype), lengths)


def _quantize_kv(x: jax.Array):
    """Per-(token, head) absmax int8 quantization. x: [.., T, K, D] ->
    (int8 values, [.., T, K] f32 scales)."""
    absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)
    scale = jnp.maximum(absmax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(x.astype(jnp.float32) / scale[..., None]),
                 -127, 127)
    return q.astype(jnp.int8), scale


def quantize_kv_embedded(x: jax.Array) -> jax.Array:
    """x: [B, T, K, D] -> int8 [B, T, K+EMBED_PAD, D] with row K carrying the
    per-head scales as log2-quantized 16-bit codes: scale = 2^(code/256),
    hi byte at lanes [0, K), low (unsigned) byte at lanes [K, 2K).
    Values are quantized against the snapped scale, so dequantization via
    the stored code is exact."""
    B, T, K, D = x.shape
    absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)    # [B,T,K]
    scale = jnp.maximum(absmax, 1e-30) / 127.0
    code = jnp.clip(jnp.round(jnp.log2(scale) * 256.0),
                    -32768, 32767).astype(jnp.int32)
    snapped = jnp.exp2(code.astype(jnp.float32) / 256.0)
    q = jnp.clip(jnp.round(x.astype(jnp.float32) / snapped[..., None]),
                 -127, 127).astype(jnp.int8)
    hi = jnp.right_shift(code, 8).astype(jnp.int8)               # [B,T,K]
    lo = jnp.bitwise_and(code, 255).astype(jnp.uint8).astype(jnp.int8)
    rows = jnp.zeros((B, T, EMBED_PAD, D), jnp.int8)
    rows = rows.at[..., 0, :K].set(hi).at[..., 0, K:2 * K].set(lo)
    return jnp.concatenate([q, rows], axis=2)


def decode_embedded_scales(srow, num_kv_heads: int):
    """Scale row(s) int8 [.., D] -> f32 scales [.., K] (exp2 + integer
    ops)."""
    K = num_kv_heads
    hi = srow[..., :K].astype(jnp.int32)
    lo = jnp.bitwise_and(srow[..., K:2 * K].astype(jnp.int32), 255)
    code = hi * 256 + lo
    return jnp.exp2(code.astype(jnp.float32) / 256.0)


def _update_one(cache_b, new_b, start):
    """cache_b: [S, K, D]; new_b: [T, K, D]; write at token ``start``."""
    return jax.lax.dynamic_update_slice(cache_b, new_b.astype(cache_b.dtype),
                                        (start, 0, 0))


def update_layer_cache(k_layer: jax.Array, v_layer: jax.Array,
                       new_k: jax.Array, new_v: jax.Array,
                       starts: jax.Array,
                       k_scale_layer: jax.Array | None = None,
                       v_scale_layer: jax.Array | None = None):
    """Write new tokens into one layer's cache at per-sequence offsets.

    k_layer/v_layer: [B, S, K, D] (one layer's slice, token-major)
    new_k/new_v:     [B, T, K, D] (T new tokens)
    starts:          [B] int32 write offsets (== history lengths)
    Returns updated (k_layer, v_layer[, k_scale_layer, v_scale_layer]);
    scale layers are [B, S, K].
    """
    if k_scale_layer is None:
        k_out = jax.vmap(_update_one)(k_layer, new_k, starts)
        v_out = jax.vmap(_update_one)(v_layer, new_v, starts)
        return k_out, v_out, None, None

    qk, k_sc = _quantize_kv(new_k)     # [B,T,K,D], [B,T,K]
    qv, v_sc = _quantize_kv(new_v)
    upd2 = jax.vmap(lambda c, n, s: jax.lax.dynamic_update_slice(
        c, n.astype(c.dtype), (s, 0)))
    k_out = jax.vmap(_update_one)(k_layer, qk, starts)
    v_out = jax.vmap(_update_one)(v_layer, qv, starts)
    ks_out = upd2(k_scale_layer, k_sc, starts)
    vs_out = upd2(v_scale_layer, v_sc, starts)
    return k_out, v_out, ks_out, vs_out


# ---------------------------------------------------------------------------
# Stacked-cache write (in place: one T-row window per sequence)
# ---------------------------------------------------------------------------

def _write_window(arr, new, layer, starts, new_len):
    """arr: [L, B, S, *rest]; new: [B, T, *rest]. For each sequence b, rows
    t < new_len[b] of ``new`` land at arr[layer, b, starts[b] + t]; the
    other rows are dropped (their scatter index is out of bounds). One
    scatter of at most T rows per sequence, nothing else is read or
    written, so under donation the update is in place."""
    B, T = new.shape[:2]
    S = arr.shape[2]
    t = jnp.arange(T, dtype=jnp.int32)[None, :]
    pos = jnp.where(t < new_len[:, None], starts[:, None] + t, S)   # [B, T]
    b = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, T))
    return arr.at[layer, b, pos].set(new.astype(arr.dtype), mode="drop")


def update_cache_at_layer(cache: KVCache, layer, new_k: jax.Array,
                          new_v: jax.Array, starts: jax.Array,
                          new_len: jax.Array | None = None) -> KVCache:
    """Write new tokens for one layer straight into the stacked 5-D cache.

    cache.k/v: [L, B, S, K, D]; new_k/new_v: [B, T, K, D]; layer: traced
    int32 scalar; starts: [B] per-sequence write offsets; new_len: [B]
    valid new tokens per sequence (rows past it, and whole sequences with
    0, leave the cache untouched; defaults to all-T). A valid row past
    the cache's end is dropped: callers keep real tokens in range.

    The capability contract is the reference's launchConcatKVCache /
    in-kernel cache write (concat_past_kv.cu:44-89,
    decoder_self_attention.cu:126,172).
    """
    if new_len is None:
        new_len = jnp.full(starts.shape, new_k.shape[1], jnp.int32)
    new_len = new_len.astype(jnp.int32)
    starts = starts.astype(jnp.int32)

    def write(arr, new):
        return _write_window(arr, new, layer, starts, new_len)

    if cache.embedded_scales:
        # values and scale codes packed into one [B, T, K+pad, D] int8 array
        return dataclasses.replace(
            cache, k=write(cache.k, quantize_kv_embedded(new_k)),
            v=write(cache.v, quantize_kv_embedded(new_v)))
    if cache.quantized:
        qk, k_sc = _quantize_kv(new_k)     # [B,T,K,D], [B,T,K]
        qv, v_sc = _quantize_kv(new_v)
        return dataclasses.replace(
            cache, k=write(cache.k, qk), v=write(cache.v, qv),
            k_scale=write(cache.k_scale, k_sc),
            v_scale=write(cache.v_scale, v_sc))
    return dataclasses.replace(cache, k=write(cache.k, new_k),
                               v=write(cache.v, new_v))
