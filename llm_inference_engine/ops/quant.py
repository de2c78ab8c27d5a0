"""Weight-only INT8 / INT4 quantization.

This realizes the capability the reference declared but never implemented:
its ``WeightType::INT8_W`` enum is defined and never used
(reference: src/weights/includes/base_weights.h:10, README.md:36-39 lists
"INT8/INT4 quantization" as future work) — and the lack of it is why the
reference could not even load Llama2-7B (README.md:9).

Schemes:
- INT8: per-output-channel absmax scales, s: [out] f32. The product runs
  on bf16 operands (q * s rounded once to bf16) with an f32 accumulator.
- INT4: two 4-bit values packed per int8 byte along the contraction axis
  (byte r carries row 2r in the low nibble and row 2r+1 in the high), with
  grouped scales s: [in/group, out] f32. Rows 2r and 2r+1 share a scale
  group, so the matmul needs no interleave: x's even contraction columns
  dot the low nibbles and its odd columns dot the high nibbles.

``quantized_linear`` is the production path (activation-dtype operands,
f32 accumulation). ``quantized_linear_ref`` dequantizes to f32 and runs the
dot at "highest" precision; only tests and chip checks use it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = [
    "QuantizedTensor",
    "quantize_tensor",
    "dequantize_tensor",
    "quantized_linear",
    "quantized_linear_ref",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuantizedTensor:
    """Quantized [in, out] weight.

    mode="int8": q int8 [in, out], scale f32 [1, out]
    mode="int4": q int8 [in//2, out] (row 2k in low nibble, 2k+1 in high),
                 scale f32 [in//group, out]
    """

    q: jax.Array
    scale: jax.Array
    mode: str = dataclasses.field(metadata=dict(static=True), default="int8")
    group_size: int = dataclasses.field(metadata=dict(static=True), default=128)

    @property
    def shape(self):
        if self.mode == "int4":
            return (self.q.shape[0] * 2, self.q.shape[1])
        return self.q.shape

    @property
    def dtype(self):
        return jnp.bfloat16

    @property
    def nbytes(self) -> int:
        return self.q.size * self.q.dtype.itemsize + self.scale.size * 4


def _pack_int4(qvals: jax.Array, group_size: int = 0) -> jax.Array:
    """[in, out] int8 in [-8, 7] -> [in//2, out] packed.

    Row-interleaved: byte r = (row 2r & 0xF) | (row 2r+1 << 4), so the
    low nibbles hold the even rows and the high nibbles the odd rows
    (``_nibbles``). ``group_size`` is accepted for API symmetry but the
    packing is group-agnostic."""
    del group_size
    k, n = qvals.shape
    lo = qvals[0::2].astype(jnp.uint8) & 0xF
    hi = (qvals[1::2].astype(jnp.uint8) & 0xF) << 4
    return (lo | hi).astype(jnp.int8)


def _unpack_int4(packed: jax.Array, group_size: int = 0) -> jax.Array:
    """[in//2, out] packed -> [in, out] int8 (reference path); inverse of
    the row interleave in _pack_int4."""
    del group_size
    k2, n = packed.shape
    b = packed.astype(jnp.int32)
    lo = jnp.right_shift(jnp.left_shift(b, 28), 28)     # sign-extend low nibble
    hi = jnp.right_shift(b, 4)                          # high nibble (signed)
    out = jnp.stack([lo, hi], axis=1)                   # [k2, 2, n]
    return out.reshape(k2 * 2, n).astype(jnp.int8)


def quantize_tensor(w: jax.Array, mode: str = "int8",
                    group_size: int = 128,
                    clip: jax.Array | None = None) -> QuantizedTensor:
    """Quantize a [in, out] weight (absmax, symmetric).

    ``clip``: optional per-scale-block clip factors in (0, 1] — [1, out]
    for int8, [in/group, out] for int4 — shrinking the absmax before the
    scale is derived (values beyond the clipped range saturate). Produced
    by ``search_clip`` (calibration-aware quantization); the storage
    format and the runtime kernels are unchanged."""
    w = w.astype(jnp.float32)
    k, n = w.shape
    if mode == "int8":
        absmax = jnp.max(jnp.abs(w), axis=0, keepdims=True)        # [1, out]
        if clip is not None:
            absmax = absmax * clip.reshape(1, n)
        scale = jnp.maximum(absmax, 1e-8) / 127.0
        q = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
        return QuantizedTensor(q=q, scale=scale, mode="int8",
                               group_size=group_size)
    if mode == "int4":
        if k % group_size != 0:
            raise ValueError(f"in dim {k} not divisible by group {group_size}")
        wg = w.reshape(k // group_size, group_size, n)
        absmax = jnp.max(jnp.abs(wg), axis=1, keepdims=True)       # [G,1,N]
        if clip is not None:
            absmax = absmax * clip.reshape(k // group_size, 1, n)
        scale = jnp.maximum(absmax, 1e-8) / 7.0
        q = jnp.clip(jnp.round(wg / scale), -8, 7).astype(jnp.int8)
        q = q.reshape(k, n)
        return QuantizedTensor(q=_pack_int4(q, group_size), scale=scale[:, 0, :],
                               mode="int4", group_size=group_size)
    raise ValueError(f"unknown quant mode {mode!r}")


_CLIP_GRID = tuple(1.0 - 0.05 * i for i in range(11))    # 1.00 .. 0.50


def search_clip(w: jax.Array, mode: str = "int4", group_size: int = 128,
                act_sq: jax.Array | None = None,
                grid=_CLIP_GRID) -> jax.Array:
    """Calibration-aware clip factors for ``quantize_tensor`` (AWQ-lite).

    Round-to-nearest absmax scales spend the whole int4 range on a block's
    single largest value; clipping the range trades saturation error on
    the few outliers for finer resolution on everything else. This grid-
    searches a clip factor per scale block minimizing the OUTPUT error of
    the linear layer under the diagonal activation approximation:

        E||x (w - w_hat)||^2  ~=  sum_i E[x_i^2] * (w - w_hat)_ij^2

    so the objective is weight-space MSE weighted per input row by the
    calibration activations' second moment ``act_sq`` [in] (uniform when
    None — plain MSE clip search). This captures the activation-aware
    part of AWQ (arXiv:2306.00978) without its weight-scaling transform,
    and leaves the storage format and every runtime kernel untouched.

    Returns clip factors: [1, out] (int8) or [in/group, out] (int4).
    """
    w = w.astype(jnp.float32)
    k, n = w.shape
    g = group_size if mode == "int4" else k
    if k % g:
        raise ValueError(f"in dim {k} not divisible by group {g}")
    qmax = 7.0 if mode == "int4" else 127.0
    wg = w.reshape(k // g, g, n)
    d = (jnp.ones((k,), jnp.float32) if act_sq is None
         else act_sq.astype(jnp.float32).reshape(k))
    dg = d.reshape(k // g, g, 1)
    absmax = jnp.maximum(jnp.max(jnp.abs(wg), axis=1, keepdims=True), 1e-8)

    best_err = None
    best_clip = None
    for alpha in grid:
        scale = absmax * alpha / qmax                       # [G, 1, N]
        # same clip range as quantize_tensor applies (-qmax-1 .. qmax):
        # the search must evaluate the exact quantizer it tunes
        q = jnp.clip(jnp.round(wg / scale), -qmax - 1, qmax)
        err = jnp.sum(dg * (wg - q * scale) ** 2, axis=1)   # [G, N]
        if best_err is None:
            best_err, best_clip = err, jnp.full_like(err, alpha)
        else:
            take = err < best_err
            best_err = jnp.where(take, err, best_err)
            best_clip = jnp.where(take, alpha, best_clip)
    return best_clip if mode == "int4" else best_clip.reshape(1, n)


def dequantize_tensor(t: QuantizedTensor) -> jax.Array:
    """Full dequantization to f32 (reference / debugging only)."""
    if t.mode == "int8":
        return t.q.astype(jnp.float32) * t.scale
    q = _unpack_int4(t.q, t.group_size).astype(jnp.float32)  # [in, out]
    k, n = q.shape
    qg = q.reshape(k // t.group_size, t.group_size, n)
    return (qg * t.scale[:, None, :]).reshape(k, n)


def _flat2d(t: QuantizedTensor) -> QuantizedTensor:
    """Per-layer weight with structured out dims (the [in, 2, I] gate|up
    stack) -> [in, out] / [groups, out]."""
    if t.q.ndim <= 2:
        return t
    return QuantizedTensor(q=t.q.reshape(t.q.shape[0], -1),
                           scale=t.scale.reshape(t.scale.shape[0], -1),
                           mode=t.mode, group_size=t.group_size)


def quantized_linear_ref(x: jax.Array, t: QuantizedTensor,
                         bias: jax.Array | None = None,
                         out_dtype: Any = None) -> jax.Array:
    """Reference: dequantize to f32 and run an f32 dot at "highest"
    precision (an f32 dot may otherwise run as TF32 on the GPU)."""
    out_dtype = out_dtype or x.dtype
    w = dequantize_tensor(_flat2d(t))
    y = jax.lax.dot_general(
        x.astype(jnp.float32), w, (((x.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(out_dtype)


def _nibbles(packed: jax.Array):
    """Packed [in//2, out] int8 -> (low, high) signed nibbles as int8:
    the even and the odd contraction rows."""
    lo = jnp.right_shift(jnp.left_shift(packed, 4), 4)
    hi = jnp.right_shift(packed, 4)
    return lo, hi


def _matmul_2d(x: jax.Array, t: QuantizedTensor) -> jax.Array:
    """x [..., in] @ dequant(t) for a 2-D weight -> f32 [..., out].

    Operands are in the activation dtype (bf16 in production) and the dot
    accumulates in f32. Each scale is folded into its weights (one
    rounding to the activation dtype). int4: x's even / odd columns dot
    the low / high nibbles — the packed layout is read once, with no
    interleave."""
    dn = (((x.ndim - 1,), (0,)), ((), ()))
    cdt = x.dtype
    if t.mode == "int8":
        # the scale is folded into the weight (one rounding to the
        # activation dtype) rather than applied to the f32 accumulator:
        # with the scale on the accumulator, XLA's fused int8 GEMM gave
        # inf in the engine's gate|up projection on the H100 while the
        # same op alone was correct (PERF.md, Findings, PR 1)
        w = t.q.astype(cdt) * t.scale.astype(cdt)
        return jax.lax.dot_general(x, w, dn,
                                   preferred_element_type=jnp.float32)
    lo, hi = _nibbles(t.q)                              # [in/2, out] each
    half = t.group_size // 2                            # packed rows/group
    s = jnp.repeat(t.scale.astype(cdt), half, axis=0)   # [in/2, out]
    w_lo = lo.astype(cdt) * s
    w_hi = hi.astype(cdt) * s
    xp = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)   # (even, odd)
    y = jax.lax.dot_general(xp[..., 0], w_lo, dn,
                            preferred_element_type=jnp.float32)
    return y + jax.lax.dot_general(xp[..., 1], w_hi, dn,
                                   preferred_element_type=jnp.float32)


# ---------------------------------------------------------------------------
# int4 matmul kernel (Pallas, Triton route)
# ---------------------------------------------------------------------------

def _int4_kernel(ly_ref, xe_ref, xo_ref, q_ref, s_ref, o_ref, *, half, bm,
                 bn, groups_per_split):
    """One [bm, bn] output tile over one split of the scale groups. Each
    packed [group/2, bn] tile is loaded once; its low and high nibbles dot
    x's even and odd columns on the tensor cores, and the group's scale
    multiplies the f32 partial product."""
    i, j, split = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    ly = ly_ref[0]
    rows, cols = pl.ds(i * bm, bm), pl.ds(j * bn, bn)

    def group(g, acc):
        gi = split * groups_per_split + g
        r = pl.ds(gi * half, half)
        p = q_ref[ly, r, cols]                             # [half, bn] int8
        lo = jnp.right_shift(jnp.left_shift(p, 4), 4).astype(jnp.bfloat16)
        hi = jnp.right_shift(p, 4).astype(jnp.bfloat16)
        d = pl.dot(xe_ref[rows, r], lo) + pl.dot(xo_ref[rows, r], hi)
        return acc + d * s_ref[ly, pl.ds(gi, 1), cols]

    o_ref[split, rows, cols] = jax.lax.fori_loop(
        0, groups_per_split, group, jnp.zeros((bm, bn), jnp.float32))


def int4_matmul_kernel(x2: jax.Array, q: jax.Array, scale: jax.Array,
                       layer, group_size: int,
                       interpret: bool = False) -> jax.Array:
    """x2 [m, in] @ dequant(q[layer]) -> f32 [m, out] for stacked packed
    int4 weights q [L, in/2, out] with grouped scales [L, in/group, out].

    Rows pad to the 16-row tile; the scale groups split in up to four
    parts so that narrow outputs still fill the card (the parts are summed
    after the call). ``interpret`` runs it on the Pallas interpreter (the
    CPU tests)."""
    m, k = x2.shape
    n = q.shape[-1]
    half = group_size // 2
    bm = 16 if m <= 16 else 64
    mp = -(-m // bm) * bm
    xp = jnp.pad(x2.astype(jnp.bfloat16), ((0, mp - m), (0, 0)))
    xp = xp.reshape(mp, k // 2, 2)
    bn = 128
    groups = k // group_size
    splits = next(d for d in (4, 2, 1) if groups % d == 0)
    out = pl.pallas_call(
        functools.partial(_int4_kernel, half=half, bm=bm, bn=bn,
                          groups_per_split=groups // splits),
        out_shape=jax.ShapeDtypeStruct((splits, mp, n), jnp.float32),
        grid=(mp // bm, n // bn, splits),
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=3),
        name="int4_matmul",
    )(jnp.asarray(layer, jnp.int32).reshape(1), xp[..., 0], xp[..., 1], q,
      scale.astype(jnp.float32))
    return out.sum(0)[:m]


#: Row counts up to which int4 matmuls run int4_matmul_kernel on the GPU
#: (decode steps); larger ones (prefill chunks) run the plain XLA path,
#: which won there. Both measured on the card (PERF.md, Findings).
INT4_KERNEL_MAX_ROWS = 64


def _on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def _use_int4_kernel(x: jax.Array, t: QuantizedTensor) -> bool:
    rows = 1
    for d in x.shape[:-1]:
        rows *= d
    return (rows <= INT4_KERNEL_MAX_ROWS and int4_kernel_fits(t)
            and _on_gpu())


def _int4_linear_kernel(x: jax.Array, t: QuantizedTensor, layer):
    """quantized_linear's int4 kernel route -> f32 [..., out]."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if layer is None:                          # one [in/2, out] weight
        f = _flat2d(t)
        ys = [int4_matmul_kernel(x2, f.q[None], f.scale[None], 0,
                                 t.group_size)]
    elif t.q.ndim == 4:                        # [L, 2, in/2, I] gate|up
        q = t.q.reshape(-1, *t.q.shape[2:])
        sc = t.scale.reshape(-1, *t.scale.shape[2:])
        ys = [int4_matmul_kernel(x2, q, sc, 2 * layer + s, t.group_size)
              for s in (0, 1)]
    else:
        ys = [int4_matmul_kernel(x2, t.q, t.scale, layer, t.group_size)]
    y = jnp.concatenate(ys, axis=-1)
    return y.reshape(*lead, y.shape[-1])


def int4_kernel_fits(t: QuantizedTensor) -> bool:
    """Shapes the int4 kernel tiles exactly: 128-wide output tiles and
    even scale groups of at least 32 rows (16 packed rows per dot)."""
    return (t.mode == "int4" and t.q.shape[-1] % 128 == 0
            and t.group_size % 32 == 0)


def quantized_linear(x: jax.Array, t: QuantizedTensor,
                     bias: jax.Array | None = None, out_dtype: Any = None,
                     *, layer=None) -> jax.Array:
    """y = x @ dequant(t) (+ bias).

    Per-layer weights: ``t.q`` is [in, out] (structured out dims like the
    [in, 2, I] gate|up stack are flattened here).

    Stacked weights (``layer`` given, a traced int32): ``t.q`` is
    [L, in, out] or [L, 2, in, I] for the gate|up stack, whose two halves
    come back concatenated as the flat [.., gate | up] layout that
    silu_and_mul consumes.
    """
    out_dtype = out_dtype or x.dtype
    if _use_int4_kernel(x, t):
        y = _int4_linear_kernel(x, t, layer)
    elif layer is not None:
        t = QuantizedTensor(
            q=jax.lax.dynamic_index_in_dim(t.q, layer, 0, keepdims=False),
            scale=jax.lax.dynamic_index_in_dim(t.scale, layer, 0,
                                               keepdims=False),
            mode=t.mode, group_size=t.group_size)
        if t.q.ndim == 3:                      # [2, in', I] gate|up stack
            y = jnp.concatenate(
                [_matmul_2d(x, QuantizedTensor(q=t.q[s], scale=t.scale[s],
                                               mode=t.mode,
                                               group_size=t.group_size))
                 for s in (0, 1)], axis=-1)
        else:
            y = _matmul_2d(x, t)
    else:
        y = _matmul_2d(x, _flat2d(t))
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(out_dtype)
