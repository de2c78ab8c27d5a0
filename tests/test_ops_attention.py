"""Unit tests: attention over the KV cache (prefill + decode + GQA).

Mirrors reference tests/unit_tests/test_decoder_self_attention.cu (CPU
masked-attention golden incl. cache semantics,
test_decoder_self_attention.cu:16-107) and the prefill chain covered by
test_repeat_kv.cu / test_build_causal_mask.cu /
tests of scale_and_mask_and_softmax — all folded into one op here, so
one NumPy golden covers causality, ragged lengths, history offsets and GQA.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from llm_inference_engine.ops.attention import attention, attention_ref


def np_attention(q, k, v, q_start, kv_len, causal=True):
    """Dense float64 golden. q: [B,Sq,H,D]; k/v: [B,K,S,D]."""
    B, Sq, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    out = np.zeros_like(q, dtype=np.float64)
    scale = 1.0 / math.sqrt(D)
    for b in range(B):
        for h in range(H):
            kh = h // G
            for i in range(Sq):
                p = q_start[b] + i
                lim = min(kv_len[b], p + 1) if causal else kv_len[b]
                if lim <= 0:
                    continue
                s = (k[b, :lim, kh].astype(np.float64)
                     @ q[b, i, h].astype(np.float64)) * scale
                e = np.exp(s - s.max())
                w = e / e.sum()
                out[b, i, h] = w @ v[b, :lim, kh].astype(np.float64)
    return out


@pytest.mark.parametrize("B,Sq,H,K,D,S", [
    (2, 10, 4, 2, 64, 64),     # GQA prefill
    (1, 1, 4, 4, 64, 32),      # MHA decode
    (3, 1, 8, 2, 128, 48),     # GQA decode
    (1, 17, 2, 1, 128, 40),    # ragged, deep GQA
])
def test_attention_matches_numpy(rng, B, Sq, H, K, D, S):
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v = rng.normal(size=(B, S, K, D)).astype(np.float32)
    q_start = rng.integers(0, max(1, S - Sq), size=(B,)).astype(np.int32)
    new = rng.integers(1, Sq + 1, size=(B,)).astype(np.int32)
    kv_len = (q_start + new).astype(np.int32)

    got = np.asarray(attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(q_start), jnp.asarray(kv_len)))
    want = np_attention(q, k, v, q_start, kv_len)

    # compare only valid q rows (padded rows are don't-care)
    for b in range(B):
        rows = int(new[b])
        np.testing.assert_allclose(got[b, :rows], want[b, :rows],
                                   atol=2e-3, rtol=2e-3)


def test_attention_prefill_matches_reference(rng):
    B, Sq, H, K, D, S = 2, 16, 8, 4, 64, 128
    q = jnp.asarray(rng.normal(size=(B, Sq, H, D)).astype(np.float32))
    k = jnp.asarray(rng.normal(size=(B, S, K, D)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(B, S, K, D)).astype(np.float32))
    qs = jnp.asarray(np.array([0, 32], np.int32))
    kl = jnp.asarray(np.array([16, 48], np.int32))
    a = attention(q, k, v, qs, kl)
    b_ = attention_ref(q, k, v, qs, kl)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b_), atol=2e-4,
                               rtol=2e-4)


def test_attention_empty_slot_is_finite(rng):
    """Slots with kv_len=0 must produce zeros, not NaN (the reference's
    softmax would NaN on an empty row; ours is guarded)."""
    q = jnp.asarray(rng.normal(size=(1, 1, 2, 64)).astype(np.float32))
    k = jnp.zeros((1, 16, 2, 64), jnp.float32)
    v = jnp.zeros((1, 16, 2, 64), jnp.float32)
    out = attention(q, k, v, jnp.asarray([0]), jnp.asarray([0]))
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.parametrize("layout", ["plain", "layered", "paged"])
@pytest.mark.parametrize("Sq", [1, 8])
def test_attention_reads_only_up_to_kv_hi(rng, layout, Sq):
    """With a static ``kv_hi`` bound, rows at or past it are never read:
    poisoning them with NaN leaves the output finite and equal to the
    reference over the clean cache."""
    B, H, K, D, S, kv_hi, page = 2, 4, 2, 64, 64, 32, 8
    q = jnp.asarray(rng.normal(size=(B, Sq, H, D)).astype(np.float32))
    k = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v = rng.normal(size=(B, S, K, D)).astype(np.float32)
    qs = jnp.asarray(np.array([3, kv_hi - Sq], np.int32))
    kl = qs + Sq
    want = np.asarray(attention_ref(q, jnp.asarray(k), jnp.asarray(v),
                                    qs, kl))
    kp, vp = k.copy(), v.copy()
    kp[:, kv_hi:] = np.nan
    vp[:, kv_hi:] = np.nan
    kw = {}
    if layout == "layered":
        kp = np.stack([np.full_like(kp, np.nan), kp])
        vp = np.stack([np.full_like(vp, np.nan), vp])
        kw = dict(layer=jnp.int32(1))
    elif layout == "paged":
        # pool page p holds rows of sequence p // MP; reversed table order
        MP = S // page
        table = np.arange(B * MP, dtype=np.int32).reshape(B, MP)[:, ::-1]
        pool_k = np.zeros((B * MP, page, K, D), np.float32)
        pool_v = np.zeros_like(pool_k)
        for b in range(B):
            for j in range(MP):
                pool_k[table[b, j]] = kp[b, j * page:(j + 1) * page]
                pool_v[table[b, j]] = vp[b, j * page:(j + 1) * page]
        kp, vp = pool_k, pool_v
        kw = dict(table=jnp.asarray(np.ascontiguousarray(table)))
    got = np.asarray(attention(q, jnp.asarray(kp), jnp.asarray(vp), qs, kl,
                               kv_hi=kv_hi, **kw))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
