"""Context-parallel KV cache: per-rank append logs with explicit positions.

Under context parallelism (mesh axis ``seq``, size n) the KV cache's token
capacity is split over the ranks. A naive block split (rank i owns global
positions [i*S/n, (i+1)*S/n)) would force cross-rank writes: a prefill
chunk's tokens are computed on the rank holding their QUERY shard, which is
not the rank owning their cache rows. Instead, this layout makes every
write rank-LOCAL by construction:

- each rank's local cache rows form an **append log**: a rank writes the
  k/v it computed at its own next free row, whatever the token's absolute
  position;
- the absolute position of every row is carried explicitly in ``kv_pos``
  (sharded like the rows), and attention masks are computed from those
  absolute positions (parallel/context_parallel.py) — so row ORDER never
  matters, only the (row -> position) mapping;
- ``llen`` [B, n] (replicated, tiny) tracks each rank's local row count.
  It is updated identically on every rank from replicated inputs, so the
  replicas never diverge.

Placement rules:
- prefill chunk of T tokens: rank i computes and appends the contiguous
  sub-chunk [i*T/n, (i+1)*T/n) (the ring needs the queries sequence-
  sharded anyway);
- decode token: every rank computes the same k/v (decode activations are
  replicated over ``seq``); the rank with the SMALLEST local log appends
  it (argmin over ``llen``, ties to the lowest rank — deterministic and
  balanced, so local capacity S/n is only exhausted when the cache really
  is full of decode tokens).

Ragged prefill chunks skew ``llen`` toward low ranks (rank 0 fills first
within each chunk); the engine mirrors ``llen`` host-side and raises
before a local log can overflow (runtime/engine.py cp guard).

Reference context: the reference has no distributed tier and its cache is
a single-device [layers, bs, heads, seq, hs] block
(src/models/llama/llama.cpp:47-69); this layout exists so the engine's
sequence capacity scales with mesh size (SURVEY.md §5 long-context row).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["CPCache", "CPSpec", "new_cp_cache", "cp_write_plan",
           "cp_llen_after", "append_kv_pos", "reset_cp_cache"]


class CPSpec(NamedTuple):
    """Static description of the context-parallel axis, plumbed through
    the model forward (models/llama.py) inside shard_map."""
    axis: str       # mesh axis name ("seq")
    n: int          # axis size


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CPCache:
    """k/v: [L, B, S, K, D] token-major, S = n * S_local rank-major chunks
    (sharded on axis 2 over ``seq``); kv_pos: [B, S] absolute position per
    row (-1 = empty, sharded with the rows); llen: [B, n] per-rank row
    counts (replicated); lengths: [B] global valid tokens (same contract
    as ops.kv_cache.KVCache.lengths).

    INT8 variants (VERDICT r4 #4 — CP exists to scale context capacity,
    so its log must be quantizable like the slot cache is):
    - separate scales: k_scale/v_scale [L, B, S, K] f32 per-(token, head);
    - embedded scales (``embedded_scales``): rows are
      [L, B, S, K+EMBED_PAD, D] int8 with the log2-coded scale row of
      ops.kv_cache.quantize_kv_embedded — values + scales in one array.
      Either way the ring's ppermute and the split-KV decode read int8
      rows: memory *and* interconnect traffic halve together.
    """

    k: jax.Array
    v: jax.Array
    kv_pos: jax.Array
    llen: jax.Array
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
        from llm_inference_engine.ops.kv_cache import EMBED_PAD
        return self.k.shape[3] - (EMBED_PAD if self.embedded_scales else 0)

    @property
    def num_ranks(self) -> int:
        return self.llen.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None or self.embedded_scales


def new_cp_cache(num_layers: int, batch_size: int, num_kv_heads: int,
                 max_seq_len: int, head_dim: int, cp: int,
                 dtype=jnp.bfloat16, quantized: bool = False,
                 embedded: bool = False,
                 shard_groups: int = 1) -> CPCache:
    """``quantized`` stores the log int8 (halving per-rank KV bytes — the
    capacity CP exists to multiply). ``embedded`` selects the
    embedded-scale int8 layout instead of separate scale planes, as in
    ops.kv_cache.new_kv_cache; ``shard_groups`` (the tensor-parallel shard count) applies the
    embedded scale rows PER model-axis shard so the local view inside
    shard_map is a self-contained embedded layout."""
    if max_seq_len % cp:
        raise ValueError(f"max_seq_len {max_seq_len} % cp {cp}")
    if num_kv_heads % shard_groups:
        raise ValueError(f"num_kv_heads {num_kv_heads} % shard_groups "
                         f"{shard_groups}")
    kv_pos = jnp.full((batch_size, max_seq_len), -1, jnp.int32)
    llen = jnp.zeros((batch_size, cp), jnp.int32)
    lengths = jnp.zeros((batch_size,), jnp.int32)
    if quantized:
        from llm_inference_engine.ops.kv_cache import (
            EMBED_PAD, embedded_supported)
        k_loc = num_kv_heads // shard_groups
        if embedded:
            if not embedded_supported(k_loc, head_dim):
                raise ValueError(f"embedded int8 scales need 2*K <= D "
                                 f"(K={k_loc}, D={head_dim})")
            shape = (num_layers, batch_size, max_seq_len,
                     shard_groups * (k_loc + EMBED_PAD), head_dim)
            return CPCache(jnp.zeros(shape, jnp.int8),
                           jnp.zeros(shape, jnp.int8),
                           kv_pos, llen, lengths, embedded_scales=True)
        shape = (num_layers, batch_size, max_seq_len, num_kv_heads,
                 head_dim)
        sshape = shape[:-1]
        return CPCache(jnp.zeros(shape, jnp.int8),
                       jnp.zeros(shape, jnp.int8),
                       kv_pos, llen, lengths,
                       k_scale=jnp.ones(sshape, jnp.float32),
                       v_scale=jnp.ones(sshape, jnp.float32))
    shape = (num_layers, batch_size, max_seq_len, num_kv_heads, head_dim)
    return CPCache(
        k=jnp.zeros(shape, dtype),
        v=jnp.zeros(shape, dtype),
        kv_pos=kv_pos,
        llen=llen,
        lengths=lengths,
    )


def cp_write_plan(llen, q_start, kv_len, me, n: int, t_local: int):
    """This rank's append window for the current forward call.

    llen [B, n] replicated; q_start/kv_len [B]; me: this rank's index on
    the seq axis (traced); t_local: static per-rank query length.
    Returns (start [B], count [B], pos0 [B]):
      start — local row offset to write at (this rank's log tail);
      count — how many of the t_local new rows are real for each slot;
      pos0  — absolute position of this rank's first new token.
    Decode (t_local == 1): the least-full rank takes the token.
    Prefill: rank i takes the chunk's contiguous [i*Tl, (i+1)*Tl) span.
    """
    new = kv_len - q_start                                     # [B]
    start = llen[:, me]                                        # [B]
    if t_local == 1:
        owner = jnp.argmin(llen, axis=1)                       # [B]
        count = ((owner == me) & (new > 0)).astype(jnp.int32)
        pos0 = q_start
    else:
        count = jnp.clip(new - me * t_local, 0, t_local)
        pos0 = q_start + me * t_local
    return start, count, pos0


def cp_llen_after(llen, q_start, kv_len, n: int, t_local: int):
    """The replicated llen update: every rank computes the same [B, n]
    result from replicated inputs (so the replicas stay in lockstep)."""
    new = kv_len - q_start                                     # [B]
    if t_local == 1:
        owner = jnp.argmin(llen, axis=1)                       # [B]
        add = (jax.nn.one_hot(owner, n, dtype=jnp.int32)
               * (new > 0)[:, None].astype(jnp.int32))
    else:
        ranks = jnp.arange(n, dtype=jnp.int32)[None, :]
        add = jnp.clip(new[:, None] - ranks * t_local, 0, t_local)
    return llen + add


def append_kv_pos(kv_pos_local, start, count, pos0, t_local: int,
                  decode_pos=None):
    """Append this rank's new rows' absolute positions into its local
    kv_pos column block. kv_pos_local: [B, S_local]; start/count/pos0: [B].
    Prefill rows get pos0 + 0..count-1; decode rows get pos0 itself."""
    B, s_local = kv_pos_local.shape
    offs = jnp.arange(t_local, dtype=jnp.int32)[None, :]       # [1, Tl]
    rows = start[:, None] + offs                               # [B, Tl]
    vals = pos0[:, None] + (offs if t_local > 1 else 0)
    valid = offs < count[:, None]
    rows = jnp.where(valid, rows, s_local)                     # drop o.o.b.
    return kv_pos_local.at[
        jnp.arange(B)[:, None], rows].set(vals, mode="drop")


def reset_cp_cache(cache: CPCache,
                   slots: Optional[jnp.ndarray] = None) -> CPCache:
    """Clear the append logs (all slots or a [m] row index array)."""
    if slots is None:
        return dataclasses.replace(
            cache,
            kv_pos=jnp.full_like(cache.kv_pos, -1),
            llen=jnp.zeros_like(cache.llen),
            lengths=jnp.zeros_like(cache.lengths))
    rows = jnp.asarray(slots, jnp.int32)
    return dataclasses.replace(
        cache,
        kv_pos=cache.kv_pos.at[rows].set(-1),
        llen=cache.llen.at[rows].set(0),
        lengths=cache.lengths.at[rows].set(0))
