"""Context-parallel attention parity: ring prefill + split-KV decode on a
virtual 8-device CPU mesh vs the single-device golden attention.

SURVEY.md §5 long-context row: ring/CP over devices is the designed extension
point beyond one chip's HBM. These tests pin that the sequence-sharded
paths (parallel/context_parallel.py) produce exactly the single-device
flash/golden numbers for causal, ragged, GQA and sliding-window cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_inference_engine.ops.attention import attention_ref
from llm_inference_engine.parallel import context_parallel as cp


def _mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    return cp.make_cp_mesh(n)


def _rand(key, shape, dtype=jnp.float32):
    return jax.random.normal(key, shape, dtype)


@pytest.mark.parametrize("gqa", [1, 4])
@pytest.mark.parametrize("ragged", [False, True])
def test_ring_prefill_parity(gqa, ragged):
    mesh = _mesh(8)
    B, T, K, D = 2, 64, 2, 16
    H = K * gqa
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    q = _rand(keys[0], (B, T, H, D))
    k = _rand(keys[1], (B, T, K, D))
    v = _rand(keys[2], (B, T, K, D))
    q_start = jnp.zeros((B,), jnp.int32)
    kv_len = (jnp.array([T, T - 13], jnp.int32) if ragged
              else jnp.full((B,), T, jnp.int32))

    got = cp.ring_prefill_sharded(mesh, q, k, v, q_start, kv_len)
    want = attention_ref(q, k, v, q_start, kv_len, causal=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_ring_prefill_with_history_offset():
    """Chunked prefill: 16 tokens of history already in the cache, the
    query chunk covers absolute positions 16..79."""
    mesh = _mesh(8)
    B, T, S, K, D, H = 2, 64, 80, 2, 16, 4
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    q = _rand(keys[0], (B, T, H, D))
    k = _rand(keys[1], (B, S, K, D))
    v = _rand(keys[2], (B, S, K, D))
    q_start = jnp.full((B,), 16, jnp.int32)
    kv_len = jnp.full((B,), S, jnp.int32)

    got = cp.ring_prefill_sharded(mesh, q, k, v, q_start, kv_len)
    want = attention_ref(q, k, v, q_start, kv_len, causal=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_ring_prefill_sliding_window():
    mesh = _mesh(8)
    B, T, K, D, H, W = 2, 64, 2, 16, 4, 24
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    q = _rand(keys[0], (B, T, H, D))
    k = _rand(keys[1], (B, T, K, D))
    v = _rand(keys[2], (B, T, K, D))
    q_start = jnp.zeros((B,), jnp.int32)
    kv_len = jnp.full((B,), T, jnp.int32)

    got = cp.ring_prefill_sharded(mesh, q, k, v, q_start, kv_len, window=W)
    want = attention_ref(q, k, v, q_start, kv_len, causal=True, window=W)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("gqa", [1, 4])
def test_split_kv_decode_parity(gqa):
    mesh = _mesh(8)
    B, S, K, D = 3, 128, 2, 16
    H = K * gqa
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    q = _rand(keys[0], (B, 1, H, D))
    k = _rand(keys[1], (B, S, K, D))
    v = _rand(keys[2], (B, S, K, D))
    kv_len = jnp.array([128, 77, 1], jnp.int32)   # ragged incl. length-1

    got = cp.split_decode_sharded(mesh, q, k, v, kv_len)
    want = attention_ref(q, k, v, kv_len - 1, kv_len, causal=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_split_kv_decode_window():
    mesh = _mesh(8)
    B, S, K, D, H, W = 2, 128, 2, 16, 4, 40
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    q = _rand(keys[0], (B, 1, H, D))
    k = _rand(keys[1], (B, S, K, D))
    v = _rand(keys[2], (B, S, K, D))
    kv_len = jnp.array([128, 100], jnp.int32)

    got = cp.split_decode_sharded(mesh, q, k, v, kv_len, window=W)
    want = attention_ref(q, k, v, kv_len - 1, kv_len, causal=True, window=W)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_merge_stats_associative_and_empty_safe():
    """The online merge is associative and a fully-masked chunk is the
    identity element (finite sentinel: no NaN)."""
    key = jax.random.PRNGKey(5)
    ks = jax.random.split(key, 9)
    shape_acc, shape_ml = (2, 4, 3, 8), (2, 4, 3)

    def mk(i):
        return (_rand(ks[3 * i], shape_acc),
                _rand(ks[3 * i + 1], shape_ml),
                jnp.abs(_rand(ks[3 * i + 2], shape_ml)) + 0.1)

    a, b, c = mk(0), mk(1), mk(2)
    left = cp.merge_stats(*cp.merge_stats(*a, *b), *c)
    right = cp.merge_stats(*a, *cp.merge_stats(*b, *c))
    for x, y in zip(left, right):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-5, atol=1e-5)

    empty = (jnp.zeros(shape_acc), jnp.full(shape_ml, -1e30),
             jnp.zeros(shape_ml))
    merged = cp.merge_stats(*a, *empty)
    for x, y in zip(merged, a):
        assert not np.any(np.isnan(np.asarray(x)))
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None)])
def test_chunk_stats_blockwise_matches_dense(causal, window):
    """The block_kv online-softmax loop (ADVICE r3: bounded score memory)
    must be bit-for-bit-tolerance equal to the dense single-block path —
    including ragged blocks, per-batch kv_pos, invalid rows, and windows."""
    B, Tq, K, G, D, Tk = 2, 5, 2, 2, 8, 37          # Tk ragged vs block 8
    H = K * G
    keys = jax.random.split(jax.random.PRNGKey(7), 5)
    q = _rand(keys[0], (B, Tq, H, D))
    k = _rand(keys[1], (B, Tk, K, D))
    v = _rand(keys[2], (B, Tk, K, D))
    q_pos = jax.random.randint(keys[3], (B, Tq), 0, 50)
    kv_pos = jax.random.randint(keys[4], (B, Tk), 0, 50)
    kv_valid = kv_pos % 5 != 0                       # scattered invalids

    dense = cp.chunk_attention_stats(q, k, v, q_pos, kv_pos, kv_valid,
                                     causal=causal, window=window,
                                     block_kv=None)
    blocked = cp.chunk_attention_stats(q, k, v, q_pos, kv_pos, kv_valid,
                                       causal=causal, window=window,
                                       block_kv=8)
    for a, b in zip(dense, blocked):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-5)


def test_ring_prefill_parity_blockwise_inner():
    """Ring attention with the blockwise inner loop engaged (block_kv
    smaller than the per-rank chunk) still matches single-device flash."""
    mesh = _mesh(4)
    B, T, K, D = 2, 64, 2, 16
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    q = _rand(keys[0], (B, T, K, D))
    k = _rand(keys[1], (B, T, K, D))
    v = _rand(keys[2], (B, T, K, D))
    q_start = jnp.zeros((B,), jnp.int32)
    kv_len = jnp.array([T, T - 9], jnp.int32)

    import functools
    orig = cp.chunk_attention_stats
    cp.chunk_attention_stats = functools.partial(orig, block_kv=8)
    try:
        got = cp.ring_prefill_sharded(mesh, q, k, v, q_start, kv_len)
    finally:
        cp.chunk_attention_stats = orig
    want = attention_ref(q, k, v, q_start, kv_len, causal=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)

# ---------------------------------------------------------------------------
# INT8 kv chunks (the quantized CP log, parallel/cp_cache.py — r4 #4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blockwise", [False, True])
def test_chunk_stats_separate_scales_match_dequant(blockwise):
    """int8 kv + [B, Tk, K] scales == stats on the dequantized bf16 rows
    (identical compute order, so the match is tight)."""
    from llm_inference_engine.ops.kv_cache import _quantize_kv
    key = jax.random.PRNGKey(0)
    B, Tq, Tk, K, G, D = 2, 4, 24, 2, 2, 16
    q = _rand(key, (B, Tq, K * G, D))
    k = _rand(jax.random.fold_in(key, 1), (B, Tk, K, D))
    v = _rand(jax.random.fold_in(key, 2), (B, Tk, K, D))
    qk, ks = _quantize_kv(k)
    qv, vs = _quantize_kv(v)
    q_pos = jnp.broadcast_to(jnp.arange(Tq)[None] + 10, (B, Tq))
    kv_pos = jnp.broadcast_to(jnp.arange(Tk)[None], (B, Tk))
    kv_valid = kv_pos < 14
    bk = 8 if blockwise else None
    got = cp.chunk_attention_stats(q, qk, qv, q_pos, kv_pos, kv_valid,
                                   k_scale=ks, v_scale=vs, block_kv=bk)
    kd = qk.astype(jnp.float32) * ks[..., None]
    vd = qv.astype(jnp.float32) * vs[..., None]
    want = cp.chunk_attention_stats(q, kd, vd, q_pos, kv_pos, kv_valid,
                                    block_kv=bk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("blockwise", [False, True])
def test_chunk_stats_embedded_match_dequant(blockwise):
    """Embedded-scale int8 rows (ops.kv_cache.quantize_kv_embedded layout)
    == stats on explicitly dequantized rows."""
    from llm_inference_engine.ops.kv_cache import (
        EMBED_PAD, decode_embedded_scales, quantize_kv_embedded)
    key = jax.random.PRNGKey(3)
    B, Tq, Tk, K, G, D = 2, 3, 16, 8, 1, 128
    q = _rand(key, (B, Tq, K * G, D))
    k = _rand(jax.random.fold_in(key, 1), (B, Tk, K, D))
    v = _rand(jax.random.fold_in(key, 2), (B, Tk, K, D))
    ek = quantize_kv_embedded(k)                     # [B, Tk, K+PAD, D]
    ev = quantize_kv_embedded(v)
    assert ek.shape[2] == K + EMBED_PAD and ek.dtype == jnp.int8
    q_pos = jnp.broadcast_to(jnp.arange(Tq)[None] + 6, (B, Tq))
    kv_pos = jnp.broadcast_to(jnp.arange(Tk)[None], (B, Tk))
    kv_valid = kv_pos < 9
    bk = 8 if blockwise else None
    got = cp.chunk_attention_stats(q, ek, ev, q_pos, kv_pos, kv_valid,
                                   embedded_kv=True, block_kv=bk)
    ksc = decode_embedded_scales(ek[:, :, K, :], K)
    vsc = decode_embedded_scales(ev[:, :, K, :], K)
    kd = ek[:, :, :K].astype(jnp.float32) * ksc[..., None]
    vd = ev[:, :, :K].astype(jnp.float32) * vsc[..., None]
    want = cp.chunk_attention_stats(q, kd, vd, q_pos, kv_pos, kv_valid,
                                    block_kv=bk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


def test_ring_attention_int8_scales_rotate():
    """Ring over a 2-rank mesh with a separate-scale int8 log: scales must
    rotate with their kv chunks (a mismatch would show immediately)."""
    from llm_inference_engine.ops.kv_cache import _quantize_kv
    mesh = _mesh(2)
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    import functools
    key = jax.random.PRNGKey(7)
    B, T, K, G, D = 2, 8, 2, 2, 16
    q = _rand(key, (B, T, K * G, D))
    k = _rand(jax.random.fold_in(key, 1), (B, T, K, D))
    v = _rand(jax.random.fold_in(key, 2), (B, T, K, D))
    qk, ks = _quantize_kv(k)
    qv, vs = _quantize_kv(v)
    kv_len = jnp.array([T, T - 3], jnp.int32)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, "seq"), P(None, "seq"), P(None, "seq"),
                  P(None, "seq"), P(None, "seq"), P()),
        out_specs=P(None, "seq"))
    def run(q_l, k_l, v_l, ks_l, vs_l, kv_len_):
        i = jax.lax.axis_index("seq")
        Tl = T // 2
        q_pos = (i * Tl + jnp.arange(Tl, dtype=jnp.int32))[None, :] + 0 * \
            kv_len_[:, None]
        kv_pos = i * Tl + jnp.arange(Tl, dtype=jnp.int32)
        kv_valid = kv_pos[None, :] < kv_len_[:, None]
        return cp.ring_attention(q_l, k_l, v_l, q_pos, kv_pos, kv_valid,
                                 "seq", 2, causal=True,
                                 k_scale=ks_l, v_scale=vs_l)

    got = np.asarray(run(q, qk, qv, ks, vs, kv_len))
    kd = qk.astype(jnp.float32) * ks[..., None]
    vd = qv.astype(jnp.float32) * vs[..., None]
    q_start = jnp.zeros((B,), jnp.int32)
    want = np.asarray(attention_ref(q, kd, vd, q_start, kv_len, causal=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
