"""Pipeline parallelism: (pipe, data, model) mesh forward == single-device.

The reference has no distributed tier; this exercises the third
parallelism axis (layer stages over ``pipe`` with ppermute activation
flow and gated cache writes) composed with TP and DP, on the virtual
8-device CPU mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from llm_inference_engine.config import EngineConfig, ModelConfig
from llm_inference_engine.models import llama as M
from llm_inference_engine.models.weights import init_dummy_params
from llm_inference_engine.ops import kv_cache as kvc
from llm_inference_engine.parallel import pipeline as PP
from llm_inference_engine.utils import cpu_devices

CFG = ModelConfig(name="pp-test", vocab_size=128, hidden_size=64,
                  intermediate_size=128, num_layers=4, num_heads=8,
                  num_kv_heads=4, head_dim=8, dtype_name="float32")


@pytest.mark.parametrize("pp,dp,tp", [(2, 2, 2), (4, 1, 2), (2, 1, 1)])
def test_pp_forward_matches_single_device(pp, dp, tp):
    ndev = pp * dp * tp
    devices = cpu_devices(ndev)
    mesh = PP.make_pp_mesh(pp=pp, dp=dp, tp=tp, devices=devices)
    B = max(2, dp)
    eng = EngineConfig(max_batch_size=B, max_seq_len=32)
    params = init_dummy_params(CFG, seed=0, scale=0.3)

    rng = np.random.default_rng(0)
    ids = jnp.asarray(rng.integers(0, CFG.vocab_size, size=(B, 6)),
                      jnp.int32)
    q0 = jnp.zeros((B,), jnp.int32)
    lens = jnp.full((B,), 6, jnp.int32)

    # golden: single device
    cache0 = kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads, 32,
                              CFG.head_dim, dtype=CFG.dtype)
    want, want_cache = M.forward_hidden(CFG, eng, params, ids, cache0,
                                        q0, lens)

    sparams = PP.shard_params_pp(params, mesh)
    scache = PP.shard_cache_pp(
        kvc.new_kv_cache(CFG.num_layers, B, CFG.num_kv_heads, 32,
                         CFG.head_dim, dtype=CFG.dtype), mesh)
    fwd = jax.jit(PP.make_pp_forward(CFG, eng, mesh, sparams))
    got, got_cache = fwd(sparams, scache, ids, q0, lens)

    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-4, rtol=2e-4)
    # caches match too (every stage wrote exactly its layers)
    np.testing.assert_allclose(np.asarray(got_cache.k),
                               np.asarray(want_cache.k), atol=2e-4,
                               rtol=2e-4)

    # and a decode step on top of the prefilled cache
    tok = jnp.argmax(got, axis=-1).astype(jnp.int32)[:, None]
    want2, _ = M.forward_hidden(CFG, eng, params, tok, want_cache, lens,
                                lens + 1)
    got2, _ = fwd(sparams, got_cache, tok, lens, lens + 1)
    np.testing.assert_allclose(np.asarray(got2), np.asarray(want2),
                               atol=2e-4, rtol=2e-4)
