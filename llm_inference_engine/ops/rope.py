"""Rotary position embeddings and the QKV split.

Capability parity with:
- ``launchFusedQKVAddBiasAndTransposeAndRope`` (reference:
  src/kernels/qkv_bias_and_rope.cu:86-138) — prefill path: split the packed
  QKV projection, apply RoPE at absolute timestep ``history + pos``, and
  lay q/k/v out for attention. The reference also re-inserts padding
  (qkv_bias_and_rope.cu:31-36); with dense static batches there is no
  padding machinery to replicate.
- ``launchRope`` (reference: src/kernels/rope.cu:60-98) — decode path:
  RoPE on the single new token at ``step-1``. Here both paths are the same
  op with different ``positions`` contents (shape-static, per-token).
- rope math (reference: src/kernels/includes/rope_utils.cuh:6-19): angle =
  m / base^(2i/d), 2-D rotation. We use the half-split (HF Llama) pairing
  so real Llama checkpoints reproduce bit-accurate logits.

The packed-qkv *split* is an XLA slice (zero-copy view into the
projection output — the reference needed a kernel for it only because it
also re-inserted padding); the *rotation* is XLA elementwise math that
fuses into the surrounding split/reshape. cos/sin are computed from the
integer positions by a Cody-Waite modular reconstruction (see
:func:`_rope_cos_sin`): plain f32 trig of a large angle loses precision
in range reduction at long positions. No [max_seq, dim] table lives in
device memory — cos/sin are fused per call.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["apply_rope", "split_qkv_rope"]


def _llama3_inv_freq_np(inv_freq, rs):
    """Llama-3.1 frequency-dependent scaling (HF rope_type "llama3"):
    wavelengths past the original context are slowed by ``factor``, short
    wavelengths kept, smooth ramp between. Host-side float64 — the result
    feeds the modular-constant tables in :func:`_rope_cos_sin`."""
    orig = float(rs.original_max_position_embeddings)
    wavelen = (2.0 * math.pi) / inv_freq
    smooth = np.clip((orig / wavelen - rs.low_freq_factor)
                     / (rs.high_freq_factor - rs.low_freq_factor), 0.0, 1.0)
    scaled = (1.0 - smooth) * inv_freq / rs.factor + smooth * inv_freq
    return np.where(wavelen < orig / rs.high_freq_factor, inv_freq,
                    np.where(wavelen > orig / rs.low_freq_factor,
                             inv_freq / rs.factor, scaled))


_TWO_PI = 2.0 * math.pi
# Cody-Waite split of 2*pi: P1 keeps 12 mantissa bits (k*P1 exact for
# k < 2^12), P2/P3 carry the remainder at full/residual f32 precision.
_P1 = float(np.float64(int(_TWO_PI * 4096.0) / 4096.0))
_P2 = float(np.float32(_TWO_PI - _P1))
_P3 = float(np.float64(_TWO_PI) - _P1 - np.float64(np.float32(_TWO_PI - _P1)))


def _rope_cos_sin(positions: jax.Array, head_dim: int, theta: float,
                  scaling=None):
    """cos/sin [..., head_dim//2] (f32) for integer positions [...].

    Plain f32 ``cos(pos * inv_freq)`` is ill-conditioned: at position
    ~30k the angle's own f32 ulp is ~2e-3, and an f32 trig range
    reduction can lose far more (the error can even differ between
    fusion contexts, so two lowerings of the same formula disagree).
    Instead the integer position is decomposed into
    bytes ``pos = a*2^16 + b*2^8 + r`` and the angle is rebuilt mod 2*pi
    from host-precomputed float64 constants ``c2 = (2^16*f) mod 2*pi``,
    ``c1 = (2^8*f) mod 2*pi`` — every term stays < 256*2*pi, then one
    Cody-Waite reduction brings it to [-pi, pi] where f32 trig is
    accurate. Absolute angle error ~2e-4 for positions up to 2^20, vs
    ~5e-2 for the naive formula. Linear ("dynamic") scaling folds into
    inv_freq (pos/s * f == pos * (f/s)); llama3 scaling transforms
    inv_freq host-side in float64.
    """
    half = head_dim // 2
    freq_exp = np.arange(half, dtype=np.float64) * (2.0 / head_dim)
    inv64 = 1.0 / (float(theta) ** freq_exp)  # [half] f64, host
    if isinstance(scaling, (int, float)):
        inv64 = inv64 / float(scaling)
    elif scaling is not None:
        inv64 = _llama3_inv_freq_np(inv64, scaling)
    c2 = jnp.asarray(np.mod(inv64 * 65536.0, _TWO_PI), jnp.float32)
    c1 = jnp.asarray(np.mod(inv64 * 256.0, _TWO_PI), jnp.float32)
    c0 = jnp.asarray(np.mod(inv64, _TWO_PI), jnp.float32)

    pos_i = positions.astype(jnp.int32)
    sign = jnp.where(pos_i < 0, -1.0, 1.0).astype(jnp.float32)[..., None]
    pos_i = jnp.abs(pos_i)
    a = (pos_i >> 16).astype(jnp.float32)[..., None]
    b = ((pos_i >> 8) & 255).astype(jnp.float32)[..., None]
    r = (pos_i & 255).astype(jnp.float32)[..., None]
    angles = a * c2 + b * c1 + r * c0            # [..., half], < ~4824
    k = jnp.round(angles * (1.0 / _TWO_PI))
    angles = ((angles - k * _P1) - k * _P2) - k * _P3
    # cos is even, sin odd: negative positions via the sign factor
    return jnp.cos(angles), sign * jnp.sin(angles)


def _rotate(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """Half-split rotation: pairs (x[i], x[i+d/2])."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].astype(jnp.float32)
    x2 = x[..., half:].astype(jnp.float32)
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return jnp.concatenate([o1, o2], axis=-1).astype(x.dtype)


def apply_rope(x: jax.Array, positions: jax.Array, theta: float = 10000.0,
               scaling: float | None = None) -> jax.Array:
    """Apply RoPE to x: [..., S, H, D] at integer positions [..., S]."""
    cos, sin = _rope_cos_sin(positions, x.shape[-1], theta, scaling)
    # broadcast over the head axis
    return _rotate(x, cos[..., None, :], sin[..., None, :])


# ---------------------------------------------------------------------------
# QKV split + RoPE
# ---------------------------------------------------------------------------
#
# Packed-QKV layout is GROUP-MAJOR: for each KV group g (of K total) the
# columns are [q_{gG} .. q_{(g+1)G-1}, k_g, v_g], i.e. the projection output
# reshapes to [..., K, G+2, D]. This keeps the reference's single fused QKV
# GEMM (layer_weights.cpp:28) while making the packed axis *contiguously
# shardable* over the tensor-parallel mesh axis: every shard receives whole
# KV groups (its q heads together with their k/v heads), independent of the
# mesh size. Since HF's GQA maps q head h to kv head h//G, group-major order
# preserves the standard head numbering h = g*G + i exactly.


def _split_grouped(qkv, num_heads: int, num_kv_heads: int, head_dim: int):
    lead = qkv.shape[:-1]
    G = num_heads // num_kv_heads
    z = qkv.reshape(*lead, num_kv_heads, G + 2, head_dim)
    q = z[..., :G, :].reshape(*lead, num_heads, head_dim)
    k = z[..., G, :]
    v = z[..., G + 1, :]
    return q, k, v


def split_qkv_rope(qkv, positions, num_heads: int, num_kv_heads: int,
                   head_dim: int, theta: float = 10000.0,
                   scaling: float | None = None):
    """Split group-major packed qkv [..., T, K*(G+2)*D] -> q [.., T, H, D],
    k/v [.., T, K, D] with RoPE applied to q and k at ``positions``."""
    q, k, v = _split_grouped(qkv, num_heads, num_kv_heads, head_dim)
    q = apply_rope(q, positions, theta, scaling)
    k = apply_rope(k, positions, theta, scaling)
    return q, k, v
