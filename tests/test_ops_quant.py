"""Unit tests: INT8/INT4 weight quantization + the quantized matmul.

No reference counterpart exists — quantization was planned, never built
(reference README.md:36-39) — so the goldens here are the quantization
error bound and the f32 dequantize-then-matmul reference.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from llm_inference_engine.ops.quant import (
    QuantizedTensor, dequantize_tensor, quantize_tensor, quantized_linear,
    quantized_linear_ref)


@pytest.mark.parametrize("mode,tol", [("int8", 0.012), ("int4", 0.16)])
def test_quantize_roundtrip_error(rng, mode, tol):
    w = rng.normal(size=(256, 128)).astype(np.float32)
    t = quantize_tensor(jnp.asarray(w), mode, 128)
    back = np.asarray(dequantize_tensor(t))
    # absmax-symmetric error bound: half an LSB of the per-col/group scale
    err = np.abs(back - w).max()
    assert err < tol * np.abs(w).max(), err


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("m,k,n", [(5, 256, 128), (64, 512, 384), (1, 128, 256)])
def test_quantized_linear_matches_reference(rng, mode, m, k, n):
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    t = quantize_tensor(jnp.asarray(w), mode, 128)
    got = np.asarray(quantized_linear(jnp.asarray(x), t))
    want = np.asarray(quantized_linear_ref(jnp.asarray(x), t))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_linear_close_to_full_precision(rng, mode):
    k, n = 512, 256
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    x = rng.normal(size=(8, k)).astype(np.float32)
    t = quantize_tensor(jnp.asarray(w), mode, 128)
    got = np.asarray(quantized_linear(jnp.asarray(x), t))
    want = x @ w
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < (0.02 if mode == "int8" else 0.2), rel


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("k", [1280, 1408])
def test_quantized_linear_ragged_k(rng, mode, k):
    """Contraction dims that 1024 does not divide (Llama's 11008 FFN dim is
    the production case) must match the reference like any other."""
    n, m = 256, 8
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    t = quantize_tensor(jnp.asarray(w), mode, 128)
    got = np.asarray(quantized_linear(jnp.asarray(x), t))
    want = np.asarray(quantized_linear_ref(jnp.asarray(x), t))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


def test_int4_pack_is_sublane_interleaved(rng):
    """Byte r must hold row 2r in the low nibble and row 2r+1 in the high —
    the layout the matmul's even/odd split reads (any other layout
    silently permutes the weight rows)."""
    from llm_inference_engine.ops.quant import _pack_int4, _unpack_int4
    q = rng.integers(-8, 8, size=(16, 4)).astype(np.int8)
    packed = np.asarray(_pack_int4(jnp.asarray(q)))
    assert packed.shape == (8, 4)
    assert (packed[0] & 0xF == (q[0] & 0xF)).all()          # row 0 -> low
    assert ((packed[0] >> 4) & 0xF == (q[1] & 0xF)).all()   # row 1 -> high
    np.testing.assert_array_equal(np.asarray(_unpack_int4(jnp.asarray(packed))), q)


def test_quantized_tensor_is_pytree():
    """Scan/tree_map must preserve static fields when slicing stacked
    quantized layers (models/weights.py stacks on a leading L axis)."""
    import jax

    w = jnp.ones((2, 128, 64))
    qs = [quantize_tensor(w[i], "int4", 64) for i in range(2)]
    stacked = QuantizedTensor(
        q=jnp.stack([t.q for t in qs]), scale=jnp.stack([t.scale for t in qs]),
        mode="int4", group_size=64)
    sliced = jax.tree.map(lambda a: a[0], stacked)
    assert isinstance(sliced, QuantizedTensor)
    assert sliced.mode == "int4" and sliced.group_size == 64
    assert sliced.q.shape == qs[0].q.shape


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("structured", [False, True])
def test_quantized_linear_large_m_prefill_path(rng, mode, structured):
    """Prefill-sized m (1024 rows) must match the f32 reference. Covers
    per-layer, stacked, and the structured gate|up stack layouts."""
    m, k, n, L = 1024, 256, 128, 2
    x = rng.normal(size=(m, k)).astype(np.float32)
    if structured:
        ws = [(rng.normal(size=(2, k, n)) * 0.02).astype(np.float32)
              for _ in range(L)]
        ts = [[quantize_tensor(jnp.asarray(w[s]), mode, 128)
               for s in range(2)] for w in ws]
        qk = k // 2 if mode == "int4" else k
        stacked = QuantizedTensor(
            q=jnp.stack([jnp.stack([t.q for t in row]) for t in [None]
                         for row in ts]).reshape(L, 2, qk, n),
            scale=jnp.stack([jnp.stack([t.scale for t in row])
                             for row in ts]),
            mode=mode, group_size=128)
        got = np.asarray(quantized_linear(
            jnp.asarray(x), stacked, layer=jnp.int32(1)))
        want = np.concatenate(
            [np.asarray(quantized_linear_ref(jnp.asarray(x), ts[1][s]))
             for s in range(2)], axis=-1)
    else:
        w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
        t = quantize_tensor(jnp.asarray(w), mode, 128)
        got = np.asarray(quantized_linear(jnp.asarray(x), t))
        want = np.asarray(quantized_linear_ref(jnp.asarray(x), t))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 0.02, rel


def test_int4_nibbles_are_even_and_odd_rows(rng):
    """The matmul's unpack: low nibbles are the even contraction rows and
    high nibbles the odd ones, sign-extended."""
    from llm_inference_engine.ops.quant import _nibbles, _pack_int4
    q = rng.integers(-8, 8, size=(32, 16)).astype(np.int8)
    lo, hi = _nibbles(_pack_int4(jnp.asarray(q)))
    np.testing.assert_array_equal(np.asarray(lo), q[0::2])
    np.testing.assert_array_equal(np.asarray(hi), q[1::2])


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("m", [8, 512])
def test_quantized_linear_bf16_activations(rng, mode, m):
    """Production numerics: bf16 activations and weights (int4 scales
    folded in at bf16), f32 accumulation — within bf16 rounding of the
    f32 reference."""
    k, n = 1024, 256
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    x = jnp.asarray(rng.normal(size=(m, k)), jnp.bfloat16)
    t = quantize_tensor(jnp.asarray(w), mode, 128)
    got = np.asarray(quantized_linear(x, t, out_dtype=jnp.float32))
    want = np.asarray(quantized_linear_ref(x, t, out_dtype=jnp.float32))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 2 ** -7, rel


@pytest.mark.parametrize("m", [5, 40])
@pytest.mark.parametrize("k", [512, 640])
def test_int4_kernel_interpret_matches_reference(rng, m, k):
    """The Pallas int4 kernel (interpret mode) on stacked weights at a
    traced layer: row padding, 2- or 4-way group splits."""
    from llm_inference_engine.ops.quant import int4_matmul_kernel
    n, L = 256, 2
    ts = [quantize_tensor(jnp.asarray(rng.normal(size=(k, n)) * 0.02,
                                      jnp.float32), "int4", 128)
          for _ in range(L)]
    q = jnp.stack([t.q for t in ts])
    s = jnp.stack([t.scale for t in ts])
    x = jnp.asarray(rng.normal(size=(m, k)), jnp.bfloat16)
    got = np.asarray(int4_matmul_kernel(x, q, s, jnp.int32(1), 128,
                                        interpret=True))
    want = np.asarray(quantized_linear_ref(x, ts[1], out_dtype=jnp.float32))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-5, rel


def test_int4_kernel_route_layouts(rng, monkeypatch):
    """quantized_linear's kernel route covers the per-layer weight, the
    stacked weight and the structured gate|up stack (interpret mode)."""
    import functools
    from llm_inference_engine.ops import quant as Q
    monkeypatch.setattr(Q, "_on_gpu", lambda: True)
    monkeypatch.setattr(Q, "int4_matmul_kernel", functools.partial(
        Q.int4_matmul_kernel, interpret=True))
    k, I, L = 256, 128, 2
    x = jnp.asarray(rng.normal(size=(3, k)), jnp.bfloat16)
    w = (rng.normal(size=(L, k, 2, I)) * 0.02).astype(np.float32)
    from llm_inference_engine.models.weights import quantize_params
    p = quantize_params({"embed": None, "final_norm": None,
                         "layers": {"wqkv": jnp.asarray(w[..., 0, :]),
                                    "wo": jnp.asarray(w[..., 1, :]),
                                    "w_gate_up": jnp.asarray(w),
                                    "w_down": jnp.asarray(w[..., 0, :])},
                         "lm_head": jnp.asarray(w[0, :, 0, :])}, "int4", 128)
    for t, ly in ((p["layers"]["wqkv"], 1), (p["layers"]["w_gate_up"], 1),
                  (p["lm_head"], None)):
        got = np.asarray(Q.quantized_linear(x, t, out_dtype=jnp.float32,
                                            layer=None if ly is None
                                            else jnp.int32(ly)))
        monkeypatch.setattr(Q, "_on_gpu", lambda: False)
        want = np.asarray(Q.quantized_linear(x, t, out_dtype=jnp.float32,
                                             layer=None if ly is None
                                             else jnp.int32(ly)))
        monkeypatch.setattr(Q, "_on_gpu", lambda: True)
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 2 ** -7, rel


def test_int4_kernel_routing(monkeypatch):
    """On the GPU, int4 matmuls of up to INT4_KERNEL_MAX_ROWS rows (decode)
    take the kernel; prefill-sized row counts, int8 weights, shapes the
    kernel does not tile, and the CPU take the plain path."""
    from llm_inference_engine.ops import quant as Q
    t4 = quantize_tensor(jnp.zeros((256, 256)), "int4", 128)
    t8 = quantize_tensor(jnp.zeros((256, 256)), "int8", 128)
    odd = quantize_tensor(jnp.zeros((256, 200)), "int4", 128)
    small, big = jnp.zeros((8, 256)), jnp.zeros((2, 512, 256))
    assert not Q._use_int4_kernel(small, t4)            # CPU backend
    monkeypatch.setattr(Q, "_on_gpu", lambda: True)
    assert Q._use_int4_kernel(small, t4)
    assert not Q._use_int4_kernel(big, t4)
    assert not Q._use_int4_kernel(small, t8)
    assert not Q._use_int4_kernel(small, odd)
