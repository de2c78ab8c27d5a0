"""Sharding tests: TP/DP shard_map forward must match single-device forward.

The reference has no distributed tier (SURVEY.md §2f); these tests validate
the new framework's mesh path on the 8-device virtual CPU mesh
(xla_force_host_platform_device_count pattern, SNIPPETS.md [2]).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from llm_inference_engine.config import EngineConfig, get_config
from llm_inference_engine.models import llama as M
from llm_inference_engine.models.weights import init_dummy_params, quantize_params
from llm_inference_engine.ops import kv_cache as kvc
from llm_inference_engine.parallel import make_mesh, sharding

CFG = get_config("debug")           # 4 heads, 2 kv heads, vocab 256
ENG = EngineConfig(max_batch_size=4, max_seq_len=32)


def _reference_logits(params, ids, lens):
    B = ids.shape[0]
    cache = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                             ENG.max_seq_len, CFG.head_dim, dtype=CFG.dtype)
    logits, cache = M.forward_hidden(
        CFG, ENG, params, jnp.asarray(ids), cache,
        jnp.zeros((B,), jnp.int32), jnp.asarray(lens, jnp.int32))
    return np.asarray(logits), cache


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 1), (2, 2), (1, 1), (4, 2)])
def test_sharded_forward_matches_single_device(rng, dp, tp):
    params = init_dummy_params(CFG, seed=0)
    B, T = 4, 8
    ids = rng.integers(0, CFG.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.array([8, 5, 8, 3], np.int32)

    want, _ = _reference_logits(params, ids, lens)

    mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices("cpu"))
    sp = sharding.shard_params(params, mesh)
    cache = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                             ENG.max_seq_len, CFG.head_dim, dtype=CFG.dtype)
    sc = sharding.shard_cache(cache, mesh)
    fwd = jax.jit(sharding.make_sharded_forward(CFG, ENG, mesh, params))
    got, new_cache = fwd(sp, sc, jnp.asarray(ids),
                         jnp.zeros((B,), jnp.int32),
                         jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4, rtol=2e-4)


def test_sharded_decode_continuation(rng):
    """Prefill then one decode step, sharded vs unsharded."""
    params = init_dummy_params(CFG, seed=1)
    B, T = 4, 6
    ids = rng.integers(0, CFG.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.full((B,), T, np.int32)
    next_tok = rng.integers(0, CFG.vocab_size, size=(B, 1)).astype(np.int32)

    # unsharded: prefill + decode
    _, cache_ref = _reference_logits(params, ids, lens)
    want_logits, _ = M.forward_hidden(
        CFG, ENG, params, jnp.asarray(next_tok), cache_ref,
        jnp.asarray(lens), jnp.asarray(lens + 1))
    want = np.asarray(want_logits)

    mesh = make_mesh(dp=2, tp=2, devices=jax.devices("cpu"))
    sp = sharding.shard_params(params, mesh)
    cache = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                             ENG.max_seq_len, CFG.head_dim, dtype=CFG.dtype)
    sc = sharding.shard_cache(cache, mesh)
    fwd = jax.jit(sharding.make_sharded_forward(CFG, ENG, mesh, params))
    _, sc = fwd(sp, sc, jnp.asarray(ids), jnp.zeros((B,), jnp.int32),
                jnp.asarray(lens))
    got, _ = fwd(sp, sc, jnp.asarray(next_tok), jnp.asarray(lens),
                 jnp.asarray(lens + 1))
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4, rtol=2e-4)


def test_sharded_quantized_forward(rng):
    """INT8-quantized params under TP: local fused dequant matmuls + psum
    must match the unsharded quantized forward."""
    params = init_dummy_params(CFG, seed=2)
    qparams = quantize_params(params, "int8")
    B, T = 2, 5
    ids = rng.integers(0, CFG.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.full((B,), T, np.int32)

    cache = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                             ENG.max_seq_len, CFG.head_dim, dtype=CFG.dtype)
    eng = ENG.replace(max_batch_size=2)
    want, _ = M.forward_hidden(CFG, eng, qparams, jnp.asarray(ids), cache,
                               jnp.zeros((B,), jnp.int32), jnp.asarray(lens))

    mesh = make_mesh(dp=1, tp=2, devices=jax.devices("cpu"))
    sp = sharding.shard_params(qparams, mesh)
    cache2 = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                              eng.max_seq_len, CFG.head_dim, dtype=CFG.dtype)
    sc = sharding.shard_cache(cache2, mesh)
    fwd = jax.jit(sharding.make_sharded_forward(CFG, eng, mesh, qparams))
    got, _ = fwd(sp, sc, jnp.asarray(ids), jnp.zeros((B,), jnp.int32),
                 jnp.asarray(lens))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


def test_mesh_validation():
    from llm_inference_engine.parallel.mesh import validate_mesh
    mesh = make_mesh(dp=1, tp=4, devices=jax.devices("cpu"))
    with pytest.raises(ValueError, match="num_kv_heads"):
        validate_mesh(CFG, ENG, mesh)  # 2 kv heads % 4 != 0


def test_multihost_mesh_single_process():
    """make_multihost_mesh on one host behaves like make_mesh."""
    from llm_inference_engine.parallel import make_multihost_mesh
    from llm_inference_engine.utils import cpu_devices
    mesh = make_multihost_mesh(dp=2, tp=4, devices=cpu_devices(8))
    assert mesh.shape["data"] == 2 and mesh.shape["model"] == 4


def test_initialize_multihost_noop():
    from llm_inference_engine.parallel import initialize_multihost
    initialize_multihost()  # single process: must be a clean no-op


# ---------------------------------------------------------------------------
# TP x fast cache modes (VERDICT r2 ask #7): tile-padded and embedded-scale
# caches under a mesh, via per-shard head groups (kv_cache shard_groups)
# ---------------------------------------------------------------------------

def _fwd_once(cfg, eng, params, cache, ids, lens, mesh=None):
    if mesh is None:
        logits, c = M.forward_hidden(cfg, eng, params, jnp.asarray(ids),
                                     cache, jnp.zeros((ids.shape[0],),
                                                      jnp.int32),
                                     jnp.asarray(lens))
        return np.asarray(logits), c
    sp = sharding.shard_params(params, mesh)
    sc = sharding.shard_cache(cache, mesh)
    fwd = jax.jit(sharding.make_sharded_forward(cfg, eng, mesh, params,
                                                cache_example=cache))
    logits, c = fwd(sp, sc, jnp.asarray(ids),
                    jnp.zeros((ids.shape[0],), jnp.int32),
                    jnp.asarray(lens))
    return np.asarray(logits), c


def test_tp_padded_cache_matches_unpadded_single_device(rng):
    """Tile-padded cache under TP: each shard's local group pads its own
    heads (shard_groups), so the padded fast path composes with the mesh
    and stays numerically exact."""
    params = init_dummy_params(CFG, seed=3)
    B, T = 2, 6
    ids = rng.integers(0, CFG.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.array([6, 4], np.int32)
    eng = ENG.replace(max_batch_size=B)

    plain = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                             eng.max_seq_len, CFG.head_dim, dtype=CFG.dtype,
                             pad_to_tiles=False)
    want, _ = _fwd_once(CFG, eng, params, plain, ids, lens)

    mesh = make_mesh(dp=1, tp=2, devices=jax.devices("cpu"))
    padded = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                              eng.max_seq_len, CFG.head_dim,
                              dtype=CFG.dtype, pad_to_tiles=True,
                              shard_groups=2)
    # per-group padding: K=2 over tp=2 -> each group 1 -> padded to 8
    Kp, Dp = kvc.aligned_kv_dims(1, CFG.head_dim)
    assert padded.k.shape[-2:] == (2 * Kp, Dp)
    got, _ = _fwd_once(CFG, eng, params, padded, ids, lens, mesh=mesh)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_tp_embedded_int8_cache_matches_single_device(rng):
    """Embedded-scale int8 cache under TP: scale rows live inside each
    shard's group, so dequantization is local — logits equal the
    single-device embedded cache exactly (same quantization math)."""
    params = init_dummy_params(CFG, seed=4)
    B, T = 2, 6
    ids = rng.integers(0, CFG.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.array([6, 5], np.int32)
    eng = ENG.replace(max_batch_size=B, kv_cache_dtype_name="int8")

    single = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                              eng.max_seq_len, CFG.head_dim,
                              dtype=CFG.dtype, quantized=True, embedded=True)
    want, _ = _fwd_once(CFG, eng, params, single, ids, lens)

    mesh = make_mesh(dp=1, tp=2, devices=jax.devices("cpu"))
    sharded = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                               eng.max_seq_len, CFG.head_dim,
                               dtype=CFG.dtype, quantized=True,
                               embedded=True, shard_groups=2)
    assert sharded.embedded_scales
    assert sharded.k.shape[-2] == 2 * (1 + kvc.EMBED_PAD)
    got, _ = _fwd_once(CFG, eng, params, sharded, ids, lens, mesh=mesh)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_tp_padded_decode_continuation(rng):
    """Padded cache under TP across a prefill -> decode boundary."""
    params = init_dummy_params(CFG, seed=5)
    B, T = 2, 5
    ids = rng.integers(0, CFG.vocab_size, size=(B, T)).astype(np.int32)
    nxt = rng.integers(0, CFG.vocab_size, size=(B, 1)).astype(np.int32)
    lens = np.full((B,), T, np.int32)
    eng = ENG.replace(max_batch_size=B)

    plain = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                             eng.max_seq_len, CFG.head_dim, dtype=CFG.dtype)
    _, c0 = _fwd_once(CFG, eng, params, plain, ids, lens)
    want, _ = M.forward_hidden(CFG, eng, params, jnp.asarray(nxt), c0,
                               jnp.asarray(lens), jnp.asarray(lens + 1))

    mesh = make_mesh(dp=2, tp=2, devices=jax.devices("cpu"))
    padded = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads,
                              eng.max_seq_len, CFG.head_dim,
                              dtype=CFG.dtype, pad_to_tiles=True,
                              shard_groups=2)
    sp = sharding.shard_params(params, mesh)
    sc = sharding.shard_cache(padded, mesh)
    fwd = jax.jit(sharding.make_sharded_forward(CFG, eng, mesh, params,
                                                cache_example=padded))
    _, c1 = fwd(sp, sc, jnp.asarray(ids), jnp.zeros((B,), jnp.int32),
                jnp.asarray(lens))
    got, _ = fwd(sp, c1, jnp.asarray(nxt), jnp.asarray(lens),
                 jnp.asarray(lens + 1))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-4, rtol=2e-4)
