"""Paged KV cache: block-table indirection over a shared page pool.

The slot cache (kv_cache.py) preallocates max_seq_len rows per slot, so
HBM bounds max_batch_size x max_seq_len even when most requests are
short. The paged cache allocates KV in fixed-size pages from one shared
pool — concurrency is bounded by TOKENS IN FLIGHT, not by the worst-case
sequence length, which is what lifts batch (and therefore serving
throughput) for realistic length mixes. The reference had neither (its
allocator pooled raw buffers for a bs=1 engine, cuda_allocator.h:23).

Layout:
- pool [L, P, page, Kst, D], token-major within a page — the same
  row content as the slot cache's [S, Kst, D] per-sequence span. A page is
  the unit of allocation ACROSS layers (physical page p = pool[:, p] on
  every layer), so the table is per-sequence, not per-layer.
- writes scatter only the new rows (``paged_update_at_layer``): each valid
  token goes to (table[b, pos // page], pos % page), in place under
  donation.
- attention gathers a sequence's pages up to the step's static ``kv_hi``
  bound (ops/attention.py).
- the allocator is host-side bookkeeping (free list); the device only
  ever sees the [B, max_pages] int32 table.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from llm_inference_engine.ops.kv_cache import EMBED_PAD, quantize_kv_embedded

__all__ = ["PagedKVCache", "PageAllocator", "new_paged_kv_cache",
           "paged_update_at_layer", "gather_layer_pages"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PagedKVCache:
    """k/v: [L, P, page, Kst, D] page pool; block_table: [B, max_pages]
    int32 physical page per (slot, logical block); lengths: [B] valid
    tokens per slot. Quantized variant: int8 pool with embedded scale
    rows (kv_cache.py quantize_kv_embedded layout)."""

    k: jax.Array
    v: jax.Array
    block_table: jax.Array
    lengths: jax.Array
    embedded_scales: bool = dataclasses.field(
        metadata=dict(static=True), default=False)

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def batch_size(self) -> int:
        return self.block_table.shape[0]

    @property
    def max_pages_per_seq(self) -> int:
        return self.block_table.shape[1]

    @property
    def max_seq_len(self) -> int:
        return self.max_pages_per_seq * self.page_size

    @property
    def num_kv_heads(self) -> int:
        return self.k.shape[3] - (EMBED_PAD if self.embedded_scales else 0)

    @property
    def quantized(self) -> bool:
        return self.embedded_scales

    # slot-cache interface shims (model/engine code paths share logic)
    k_scale = None
    v_scale = None


def new_paged_kv_cache(num_layers: int, batch_size: int, num_kv_heads: int,
                       num_pages: int, page_size: int, head_dim: int,
                       max_pages_per_seq: int, dtype=jnp.bfloat16,
                       quantized: bool = False) -> PagedKVCache:
    Kst = num_kv_heads + (EMBED_PAD if quantized else 0)
    shape = (num_layers, num_pages, page_size, Kst, head_dim)
    dt = jnp.int8 if quantized else dtype
    return PagedKVCache(
        k=jnp.zeros(shape, dt), v=jnp.zeros(shape, dt),
        block_table=jnp.zeros((batch_size, max_pages_per_seq), jnp.int32),
        lengths=jnp.zeros((batch_size,), jnp.int32),
        embedded_scales=quantized)


class PageAllocator:
    """Host-side free list over the pool's physical pages, with reference
    counting so pages can be SHARED read-only across slots (zero-copy
    prefix caching: one prefix's pages appear in many block tables).
    Page 0 is RESERVED as the scratch target every unused table entry
    points at (clamped index maps may touch it; it never holds live
    data)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))   # stack, 0 reserved
        self._rc: dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"paged KV pool exhausted: want {n} pages, "
                              f"{len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add a reference to already-allocated pages (a slot adopting a
        shared prefix's pages)."""
        for p in pages:
            if p not in self._rc:
                raise ValueError(f"page {p} is not allocated")
            self._rc[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page returns to the pool when
        its last reference goes."""
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"bad page id {p}")
            rc = self._rc.get(p, 0)
            if rc <= 0:
                raise ValueError(f"double free of page {p}")
            if rc == 1:
                del self._rc[p]
                self._free.append(p)
            else:
                self._rc[p] = rc - 1


# ---------------------------------------------------------------------------
# Writes
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, donate_argnums=(0, 1))
def _paged_write(k, v, knew, vnew, starts, nlen, layer, table):
    """Per-token scatter of the valid new rows into the pool; invalid rows
    get an out-of-bounds row index and are dropped."""
    L, P, page, Kst, D = k.shape
    B, T = knew.shape[0], knew.shape[1]
    pos = starts[:, None] + jnp.arange(T)[None, :]            # [B, T]
    valid = jnp.arange(T)[None, :] < nlen[:, None]
    pg = jnp.take_along_axis(table, jnp.where(valid, pos // page, 0),
                             axis=1)                          # [B, T]
    flat = jnp.where(valid, pg * page + pos % page, P * page)
    # pool pages viewed as rows [L, P*page, Kst, D] for one scatter
    kf = k.reshape(L, P * page, Kst, D).at[layer, flat].set(
        knew.astype(k.dtype), mode="drop")
    vf = v.reshape(L, P * page, Kst, D).at[layer, flat].set(
        vnew.astype(v.dtype), mode="drop")
    return kf.reshape(k.shape), vf.reshape(v.shape)


def paged_update_at_layer(cache: PagedKVCache, layer, new_k, new_v,
                          starts, new_len=None) -> PagedKVCache:
    """Write new tokens for one layer into the page pool.

    new_k/new_v: [B, T, K, D] float (quantized pools pack them via
    quantize_kv_embedded); starts: [B] absolute token offsets; new_len:
    [B] valid tokens (0 skips the row; 1 = decode write at any offset;
    >1 = chunk write that must start page-aligned — engine invariant).
    """
    if new_len is None:
        new_len = jnp.full(starts.shape, new_k.shape[1], jnp.int32)
    if cache.embedded_scales:
        new_k = quantize_kv_embedded(new_k)
        new_v = quantize_kv_embedded(new_v)
    k, v = _paged_write(cache.k, cache.v, new_k.astype(cache.k.dtype),
              new_v.astype(cache.v.dtype), starts.astype(jnp.int32),
              new_len.astype(jnp.int32), layer, cache.block_table)
    return dataclasses.replace(cache, k=k, v=v)


def gather_layer_pages(cache: PagedKVCache, layer):
    """Dense [B, max_seq, Kst, D] view of one layer (reference path —
    gathers the whole table; rows past ``lengths`` are whatever page 0
    holds and must be masked by the caller's kv_len)."""
    kl = jax.lax.dynamic_index_in_dim(cache.k, layer, 0, keepdims=False)
    vl = jax.lax.dynamic_index_in_dim(cache.v, layer, 0, keepdims=False)
    B, MP = cache.block_table.shape
    page, Kst, D = cache.k.shape[2], cache.k.shape[3], cache.k.shape[4]
    kd = jnp.take(kl, cache.block_table.reshape(-1), axis=0).reshape(
        B, MP * page, Kst, D)
    vd = jnp.take(vl, cache.block_table.reshape(-1), axis=0).reshape(
        B, MP * page, Kst, D)
    return kd, vd
