"""Calibration-aware quantization (VERDICT r4 #6): per-block clip search
must strictly improve on round-to-nearest for outlier-heavy weights, in
the activation-weighted objective AND in true end-output error — while
leaving the storage format (and thus every runtime kernel) unchanged.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from llm_inference_engine.ops.quant import (
    QuantizedTensor, dequantize_tensor, quantize_tensor, search_clip)


def _outlier_weight(rng, k, n, frac=0.02, gain=12.0):
    """Per-element outliers: a few huge values inside each column make
    absmax RTN spend the whole int4 range on them."""
    w = rng.standard_normal((k, n)).astype(np.float32)
    mask = rng.random((k, n)) < frac
    return np.where(mask, w * gain, w)


@pytest.mark.parametrize("mode,gs,bar", [("int4", 32, 0.9),
                                         ("int4", 64, 0.9),
                                         ("int8", 32, 1.0)])
def test_clip_search_beats_rtn_weighted_mse(rng, mode, gs, bar):
    """int4's 15 levels gain >10% from clipping outlier blocks; int8's
    127 levels gain little — but the search may NEVER be worse than RTN
    (alpha=1.0 is in the grid)."""
    w = jnp.asarray(_outlier_weight(rng, 128, 64))
    act_sq = jnp.asarray((rng.standard_normal(128).astype(np.float32) ** 2
                          + 0.05))
    clip = search_clip(w, mode, gs, act_sq=act_sq)
    rtn = dequantize_tensor(quantize_tensor(w, mode, gs))
    cal = dequantize_tensor(quantize_tensor(w, mode, gs, clip=clip))
    d = np.asarray(act_sq)[:, None]
    err_rtn = float(np.sum(d * np.asarray(w - rtn) ** 2))
    err_cal = float(np.sum(d * np.asarray(w - cal) ** 2))
    assert err_cal <= err_rtn * bar, (err_cal, err_rtn)


def test_clip_search_improves_true_output_error(rng):
    """The diagonal approximation must translate into real ||x w - x w_q||
    improvement on a held-out batch drawn from the calibration dist."""
    k, n = 256, 96
    w = jnp.asarray(_outlier_weight(rng, k, n))
    # anisotropic activations (some dims hot — the AWQ observation)
    scales = (rng.standard_normal(k).astype(np.float32) ** 2 + 0.1)
    x_cal = jnp.asarray(rng.standard_normal((64, k)).astype(np.float32)
                        * scales)
    x_test = jnp.asarray(rng.standard_normal((64, k)).astype(np.float32)
                         * scales)
    act_sq = jnp.mean(x_cal ** 2, axis=0)
    clip = search_clip(w, "int4", 64, act_sq=act_sq)
    rtn = dequantize_tensor(quantize_tensor(w, "int4", 64))
    cal = dequantize_tensor(quantize_tensor(w, "int4", 64, clip=clip))
    ref = x_test @ w
    err_rtn = float(jnp.mean((x_test @ rtn - ref) ** 2))
    err_cal = float(jnp.mean((x_test @ cal - ref) ** 2))
    assert err_cal < err_rtn, (err_cal, err_rtn)


def test_clip_none_when_no_outliers(rng):
    """Near-uniform blocks want no clipping — the search must be able to
    return 1.0 (RTN) rather than always shrinking."""
    w = jnp.asarray(rng.uniform(-1, 1, (64, 32)).astype(np.float32))
    clip = search_clip(w, "int4", 32)
    assert float(jnp.max(clip)) == 1.0


def test_calibrated_format_identical(rng):
    """quantize_tensor with clip produces the same shapes/dtypes/pack
    layout as RTN — the runtime kernel contract."""
    w = jnp.asarray(_outlier_weight(rng, 128, 64))
    t0 = quantize_tensor(w, "int4", 32)
    clip = search_clip(w, "int4", 32)
    t1 = quantize_tensor(w, "int4", 32, clip=clip)
    assert t0.q.shape == t1.q.shape and t0.q.dtype == t1.q.dtype
    assert t0.scale.shape == t1.scale.shape
    assert t1.mode == "int4" and t1.group_size == 32


def test_quantize_params_calibrated_runs_and_matches_format(rng):
    from llm_inference_engine.config import get_config
    from llm_inference_engine.models.weights import (
        calibrate_act_sq, init_dummy_params, quantize_params,
        quantize_params_calibrated)
    cfg = get_config("debug")
    params = init_dummy_params(cfg, seed=0)
    toks = [rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)]
    act_sq = calibrate_act_sq(cfg, params, toks)
    assert set(act_sq) == {"wqkv", "wo", "w_gate_up", "w_down"}
    assert act_sq["wqkv"].shape == (cfg.num_layers, cfg.hidden_size)
    assert act_sq["w_down"].shape == (cfg.num_layers, cfg.intermediate_size)
    assert float(jnp.min(act_sq["wqkv"])) > 0.0
    qp_rtn = quantize_params(params, "int8", 32)
    qp_cal = quantize_params_calibrated(params, act_sq, "int8", 32)
    for k in qp_rtn["layers"]:
        a, b = qp_rtn["layers"][k], qp_cal["layers"][k]
        if isinstance(a, QuantizedTensor):
            assert a.q.shape == b.q.shape and a.scale.shape == b.scale.shape
