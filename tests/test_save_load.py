"""save_params / load_saved_params round-trip (quantize-once checkpoints)."""

import numpy as np
import jax.numpy as jnp
import pytest

from llm_inference_engine.config import EngineConfig, get_config
from llm_inference_engine.models.weights import (
    init_dummy_params, init_dummy_quantized_params, load_saved_params,
    quantize_params, save_params)
from llm_inference_engine.ops.quant import QuantizedTensor


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_round_trip_bitwise(tmp_path, quant):
    cfg = get_config("debug")
    if quant:
        params = quantize_params(init_dummy_params(cfg, seed=3), quant,
                                 group_size=16)
    else:
        params = init_dummy_params(cfg, seed=3)
    p = str(tmp_path / "ckpt.npz")
    save_params(params, p)
    back = load_saved_params(p)

    def cmp(a, b):
        if isinstance(a, QuantizedTensor):
            assert a.mode == b.mode and a.group_size == b.group_size
            np.testing.assert_array_equal(np.asarray(a.q), np.asarray(b.q))
            np.testing.assert_array_equal(np.asarray(a.scale),
                                          np.asarray(b.scale))
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))

    cmp(params["embed"], back["embed"])
    for k in params["layers"]:
        cmp(params["layers"][k], back["layers"][k])
    cmp(params["final_norm"], back["final_norm"])
    cmp(params["lm_head"], back["lm_head"])


def test_engine_from_saved_npz(tmp_path):
    """create_engine on a .npz path must produce identical logits to the
    engine built from the in-memory params."""
    from llm_inference_engine.models.registry import create_engine
    from llm_inference_engine.runtime.engine import InferenceEngine

    cfg = get_config("debug")
    eng = EngineConfig(max_batch_size=1, max_seq_len=32, quant_mode="int8")
    params = init_dummy_quantized_params(cfg, "int8", seed=1)
    p = str(tmp_path / "debug-int8.npz")
    save_params(params, p)

    prompts = [[1, 9, 23, 5]]
    a = InferenceEngine(cfg, eng, params).prefill(prompts)
    b = create_engine("debug", p, eng).prefill(prompts)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
