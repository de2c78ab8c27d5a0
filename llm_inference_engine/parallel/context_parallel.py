"""Context (sequence) parallelism: ring attention + split-KV decode.

The reference is bounded to max_seq_len=64 on one device (SURVEY.md §5
long-context row: prefill materializes the full [bs, h, q, k] score tensor,
src/layers/context_attention.cpp:54). This repo's single-device answer is
kv_hi-bounded attention + paged KV; THIS module is the beyond-one-device
axis: shard the sequence itself over a mesh axis so neither the KV cache
nor the attention working set has to fit one device's memory.

Design (not a translation — the reference has no distributed tier at
all):

- **Ring attention for prefill**: queries and KV are both sequence-sharded
  over the ``seq`` mesh axis. Each rank runs blockwise attention of its
  local query chunk against the KV chunk it currently holds, accumulating
  online-softmax partials (acc, m, l); KV chunks rotate around the ring
  with ``ppermute`` over the device interconnect. After ``n`` hops every query chunk has seen
  every KV chunk, and the partials finalize to exactly the same values a
  single-device flash attention produces. Compute on each hop overlaps the
  next hop's ppermute (XLA's latency-hiding scheduler does this once both
  are in one program — the loop is unrolled, not a host loop).

- **Split-KV decode** (flash-decoding): at Sq=1 a ring is pure latency —
  instead every rank attends its LOCAL KV shard in one shot, and the
  partials combine with three tiny collectives: pmax of the running max,
  psum of the rescaled accumulators, psum of the rescaled normalizers.
  The KV stream — the decode bottleneck — reads at n devices' aggregate
  memory bandwidth.

Causality never depends on shard order: masks are computed from ABSOLUTE
positions (q_pos, kv_pos) carried alongside the chunks, so rotation order
is irrelevant and ragged per-sequence lengths (kv_valid) compose.

Numerics: the online-softmax merge uses the finite sentinel -1e30 (not
-inf) so fully-masked chunks merge as exp(0)=1 against l=0 contributions —
zero, never NaN (same policy as ops/attention.py's empty-row rule).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map  # type: ignore[attr-defined]
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

__all__ = ["SEQ_AXIS", "make_cp_mesh", "chunk_attention_stats",
           "merge_stats", "ring_attention", "split_kv_decode_attention",
           "ring_prefill_sharded", "split_decode_sharded"]

SEQ_AXIS = "seq"
_NEG = -1e30


def make_cp_mesh(cp: int, devices: Optional[Sequence[jax.Device]] = None
                 ) -> Mesh:
    """A 1-D (seq=cp,) mesh for context parallelism."""
    if devices is None:
        devices = jax.devices()
    if len(devices) < cp:
        raise ValueError(f"need {cp} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:cp]), (SEQ_AXIS,))


def chunk_attention_stats(q, k, v, q_pos, kv_pos, kv_valid, *,
                          sm_scale: Optional[float] = None,
                          causal: bool = True,
                          window: Optional[int] = None,
                          block_kv: Optional[int] = 512,
                          k_scale=None, v_scale=None,
                          embedded_kv: bool = False):
    """Online-softmax partials of a query chunk vs ONE kv chunk.

    ``block_kv``: the kv chunk is processed in blocks of this many rows
    with an online-softmax merge between blocks (lax.scan), so the
    score working set is [B, K, G, Tq, block_kv] instead of the full
    [B, K, G, Tq, Tk] (at long-context shapes the dense per-hop score
    tensor itself would not fit device memory — e.g. 128k over 8 devices
    is a 16k x 16k f32 score block per head). None (or Tk <= block_kv)
    keeps the single-block dense path. Per block the compute holds one
    [B, K, G, Tq, block_kv] f32 score tile plus the [B, Tq, H, D] f32
    accumulator, so per-shard memory is O(Tq * block_kv) per head —
    independent of the shard's total kv length.

    q:        [B, Tq, H, D]
    q_pos:    [B, Tq] int32   absolute position of each query row
    k, v:     [B, Tk, K, D]   (GQA-native: G = H // K)
    kv_pos:   [Tk] or [B, Tk] int32 absolute position of each kv row
              (per-batch under the CP append-log cache layout, where each
              slot's local rows map to different positions —
              parallel/cp_cache.py)
    kv_valid: [B, Tk] bool    kv row holds a real token (pos < kv_len)

    INT8 kv (the quantized CP log, parallel/cp_cache.py): either
    ``k_scale``/``v_scale`` [B, Tk, K] f32 per-(token, head) scales, or
    ``embedded_kv=True`` with k/v int8 [B, Tk, K+EMBED_PAD, D] carrying
    log2-coded scale rows (ops.kv_cache.quantize_kv_embedded layout).
    Dequantization happens per block inside the scan body, so memory
    traffic stays int8 (XLA fuses the cast+scale into the block's
    attention).

    Returns (acc, m, l):
      acc [B, Tq, H, D] f32 — sum_j exp(s_j - m) * v_j  (unnormalized)
      m   [B, Tq, H]    f32 — chunk-local running max (sentinel -1e30)
      l   [B, Tq, H]    f32 — sum_j exp(s_j - m)
    """
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    K = k.shape[2]
    kv_pos_b = (kv_pos if kv_pos.ndim == 2
                else jnp.broadcast_to(kv_pos[None, :], (B, Tk)))

    if block_kv is None or Tk <= block_kv:
        return _chunk_stats_dense(q, k, v, q_pos, kv_pos_b, kv_valid,
                                  sm_scale=sm_scale, causal=causal,
                                  window=window, k_scale=k_scale,
                                  v_scale=v_scale, embedded_kv=embedded_kv)

    pad = (-Tk) % block_kv
    if pad:
        # padded rows are masked out through kv_valid=False (kv_pos pads
        # with -1, which a causal mask alone would NOT exclude)
        k = jnp.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
        v = jnp.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
        kv_pos_b = jnp.pad(kv_pos_b, ((0, 0), (0, pad)),
                           constant_values=-1)
        kv_valid = jnp.pad(kv_valid, ((0, 0), (0, pad)),
                           constant_values=False)
        if k_scale is not None:
            k_scale = jnp.pad(k_scale, ((0, 0), (0, pad), (0, 0)),
                              constant_values=1.0)
            v_scale = jnp.pad(v_scale, ((0, 0), (0, pad), (0, 0)),
                              constant_values=1.0)
    nb = (Tk + pad) // block_kv

    def blocks(x):                            # [B, nb*bk, ...] -> xs
        return jnp.moveaxis(
            x.reshape(B, nb, block_kv, *x.shape[2:]), 1, 0)

    xs = (blocks(k), blocks(v), blocks(kv_pos_b), blocks(kv_valid),
          blocks(k_scale) if k_scale is not None else None,
          blocks(v_scale) if v_scale is not None else None)

    def body(carry, xs_b):
        kb, vb, pb, valb, ksb, vsb = xs_b
        a2, m2, l2 = _chunk_stats_dense(q, kb, vb, q_pos, pb, valb,
                                        sm_scale=sm_scale, causal=causal,
                                        window=window, k_scale=ksb,
                                        v_scale=vsb, embedded_kv=embedded_kv)
        return merge_stats(*carry, a2, m2, l2), None

    # neutral online-softmax element, derived from q so its axis-varying
    # type matches the block outputs under shard_map's vma tracking
    qf0 = q.astype(jnp.float32) * 0.0
    init = (qf0, qf0[..., 0] + _NEG, qf0[..., 0])
    (acc, m, l), _ = jax.lax.scan(body, init, xs)
    return acc, m, l


def _chunk_stats_dense(q, k, v, q_pos, kv_pos_b, kv_valid, *,
                       sm_scale, causal, window, k_scale=None, v_scale=None,
                       embedded_kv=False):
    """Single-block dense stats (see chunk_attention_stats)."""
    B, Tq, H, D = q.shape
    if embedded_kv:
        from llm_inference_engine.ops.kv_cache import (
            EMBED_PAD, decode_embedded_scales)
        K = k.shape[2] - EMBED_PAD
        k_scale = decode_embedded_scales(k[:, :, K, :], K)   # [B, Tk, K]
        v_scale = decode_embedded_scales(v[:, :, K, :], K)
        k, v = k[:, :, :K], v[:, :, :K]
    K = k.shape[2]
    G = H // K
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)

    qf = q.astype(jnp.float32).reshape(B, Tq, K, G, D)
    kf = k.astype(jnp.float32)
    vf = v.astype(jnp.float32)
    if k_scale is not None:
        kf = kf * k_scale.astype(jnp.float32)[..., None]
        vf = vf * v_scale.astype(jnp.float32)[..., None]

    s = jnp.einsum("bikgd,btkd->bkgit", qf, kf) * scale   # [B,K,G,Tq,Tk]
    visible = kv_valid[:, None, :]                        # [B, 1, Tk]
    if causal:
        visible = visible & (kv_pos_b[:, None, :]
                             <= q_pos[:, :, None])        # [B, Tq, Tk]
        if window is not None:
            visible = visible & (kv_pos_b[:, None, :]
                                 > q_pos[:, :, None] - window)
    else:
        visible = jnp.broadcast_to(visible, (B, Tq, k.shape[1]))
    vis = visible[:, None, None, :, :]                    # [B,1,1,Tq,Tk]
    s = jnp.where(vis, s, _NEG)
    m = jnp.max(s, axis=-1)                               # [B,K,G,Tq]
    p = jnp.exp(s - m[..., None])
    p = jnp.where(vis, p, 0.0)
    l = jnp.sum(p, axis=-1)                               # [B,K,G,Tq]
    acc = jnp.einsum("bkgit,btkd->bikgd", p, vf)          # [B,Tq,K,G,D]

    perm = (0, 3, 1, 2)                                   # -> [B,Tq,K,G]
    return (acc.reshape(B, Tq, H, D),
            jnp.transpose(m, perm).reshape(B, Tq, H),
            jnp.transpose(l, perm).reshape(B, Tq, H))


def merge_stats(acc1, m1, l1, acc2, m2, l2):
    """Online-softmax merge of two partial chunks (associative +
    commutative, so ring order never matters)."""
    m = jnp.maximum(m1, m2)
    a1 = jnp.exp(m1 - m)
    a2 = jnp.exp(m2 - m)
    return (acc1 * a1[..., None] + acc2 * a2[..., None],
            m,
            l1 * a1 + l2 * a2)


def _finalize(acc, l):
    l_safe = jnp.where(l == 0.0, 1.0, l)
    return acc / l_safe[..., None]


def ring_attention(q, k, v, q_pos, kv_pos, kv_valid, axis_name: str,
                   num_shards: int, *, sm_scale: Optional[float] = None,
                   causal: bool = True, window: Optional[int] = None,
                   out_dtype=None, k_scale=None, v_scale=None, embedded_kv: bool = False):
    """Ring attention over sequence-sharded q AND kv. Call inside
    ``shard_map`` with everything already local:

    q [B, Tq_local, H, D], k/v [B, Tk_local, K, D], q_pos [B, Tq_local],
    kv_pos [Tk_local], kv_valid [B, Tk_local].

    KV chunks (values + their absolute positions + validity — and, for a
    quantized log, the scales) rotate ``num_shards - 1`` times via
    ppermute; partials merge locally. The loop is a compile-time unroll so
    XLA overlaps hop i+1's ppermute with hop i's attention compute. An
    int8 log rotates int8 rows: half the interconnect bytes of a bf16 ring.
    """
    perm = [(i, (i + 1) % num_shards) for i in range(num_shards)]

    def rotate(x):
        return jax.lax.ppermute(x, axis_name, perm)

    acc, m, l = chunk_attention_stats(
        q, k, v, q_pos, kv_pos, kv_valid, sm_scale=sm_scale,
        causal=causal, window=window,
        k_scale=k_scale, v_scale=v_scale, embedded_kv=embedded_kv)
    cur = (k, v, kv_pos, kv_valid, k_scale, v_scale)
    for _ in range(num_shards - 1):
        cur = jax.tree.map(rotate, cur)
        kc, vc, pc, valc, ksc, vsc = cur
        acc2, m2, l2 = chunk_attention_stats(
            q, kc, vc, q_pos, pc, valc, sm_scale=sm_scale,
            causal=causal, window=window,
            k_scale=ksc, v_scale=vsc, embedded_kv=embedded_kv)
        acc, m, l = merge_stats(acc, m, l, acc2, m2, l2)
    out = _finalize(acc, l)
    return out.astype(out_dtype or q.dtype)


def split_kv_decode_attention(q, k, v, q_pos, kv_pos, kv_valid,
                              axis_name: str, *,
                              sm_scale: Optional[float] = None,
                              window: Optional[int] = None,
                              out_dtype=None, k_scale=None, v_scale=None,
                              embedded_kv: bool = False):
    """Flash-decoding over a sequence-sharded KV cache (Sq small, usually
    1): every rank attends its LOCAL shard, partials combine with one pmax
    + two psums — no ring, minimum latency, aggregate memory bandwidth.

    Shapes as in ring_attention (q fully replicated across the seq axis).
    """
    acc, m, l = chunk_attention_stats(
        q, k, v, q_pos, kv_pos, kv_valid, sm_scale=sm_scale,
        causal=True, window=window,
        k_scale=k_scale, v_scale=v_scale, embedded_kv=embedded_kv)
    m_g = jax.lax.pmax(m, axis_name)
    w = jnp.exp(m - m_g)
    acc_g = jax.lax.psum(acc * w[..., None], axis_name)
    l_g = jax.lax.psum(l * w, axis_name)
    out = _finalize(acc_g, l_g)
    return out.astype(out_dtype or q.dtype)


# ---------------------------------------------------------------------------
# shard_map wiring helpers (used by the tests and as integration templates)
# ---------------------------------------------------------------------------

def ring_prefill_sharded(mesh: Mesh, q, k_cache, v_cache, q_start, kv_len,
                         *, sm_scale: Optional[float] = None,
                         window: Optional[int] = None):
    """Full ring-attention prefill over a (seq,) mesh.

    q [B, T, H, D] sharded on T; k/v caches [B, S, K, D] sharded on S;
    q_start/kv_len [B] replicated. T and S must divide the axis size.
    Query row t of sequence b sits at absolute position q_start[b] + t;
    kv slot s holds absolute position s, valid iff s < kv_len[b].
    """
    n = mesh.shape[SEQ_AXIS]
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    if T % n or S % n:
        raise ValueError(f"T {T} and S {S} must divide seq={n}")
    Tl, Sl = T // n, S // n

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, SEQ_AXIS), P(None, SEQ_AXIS), P(None, SEQ_AXIS),
                  P(), P()),
        out_specs=P(None, SEQ_AXIS))
    def run(q_l, k_l, v_l, q_start_, kv_len_):
        i = jax.lax.axis_index(SEQ_AXIS)
        q_pos = (q_start_[:, None] + i * Tl
                 + jnp.arange(Tl, dtype=jnp.int32)[None, :])
        kv_pos = i * Sl + jnp.arange(Sl, dtype=jnp.int32)
        kv_valid = kv_pos[None, :] < kv_len_[:, None]
        return ring_attention(q_l, k_l, v_l, q_pos, kv_pos, kv_valid,
                              SEQ_AXIS, n, sm_scale=sm_scale, causal=True,
                              window=window)

    return run(q, k_cache, v_cache, q_start, kv_len)


def split_decode_sharded(mesh: Mesh, q, k_cache, v_cache, kv_len, *,
                         sm_scale: Optional[float] = None,
                         window: Optional[int] = None):
    """Split-KV decode over a (seq,) mesh: q [B, 1, H, D] replicated,
    caches [B, S, K, D] sharded on S, kv_len [B] replicated (the newest
    token lives at kv slot kv_len-1, i.e. q_pos = kv_len - 1)."""
    n = mesh.shape[SEQ_AXIS]
    S = k_cache.shape[1]
    if S % n:
        raise ValueError(f"S {S} must divide seq={n}")
    Sl = S // n

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(None, SEQ_AXIS), P(None, SEQ_AXIS), P()),
        out_specs=P())
    def run(q_l, k_l, v_l, kv_len_):
        i = jax.lax.axis_index(SEQ_AXIS)
        q_pos = kv_len_[:, None] - 1                     # [B, 1]
        kv_pos = i * Sl + jnp.arange(Sl, dtype=jnp.int32)
        kv_valid = kv_pos[None, :] < kv_len_[:, None]
        return split_kv_decode_attention(
            q_l, k_l, v_l, q_pos, kv_pos, kv_valid, SEQ_AXIS,
            sm_scale=sm_scale, window=window)

    return run(q, k_cache, v_cache, kv_len)
