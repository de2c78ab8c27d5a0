"""Float32 reference forward of a Llama-class decoder (teacher-forced).

An independent, plain ``jax.numpy`` implementation of what
``models/llama.py`` computes, for checking the production path: no KV
cache, no chunking, no kernels — every position of a token sequence in one
causal pass, every matmul in float32 at "highest" precision (an f32 dot may
otherwise run as TF32 on the GPU). Rotary angles come from float64 host
tables. Quantized weights are dequantized to float32 one layer at a time
inside the layer scan, so the reference holds one layer's float32 weights
at a time next to the stored ones.

Only tests and chip checks use it.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from llm_inference_engine.config import ModelConfig
from llm_inference_engine.ops.quant import QuantizedTensor, dequantize_tensor

__all__ = ["reference_logits"]

_HP = jax.lax.Precision.HIGHEST


def _rope_tables(cfg: ModelConfig, T: int):
    """cos/sin [T, D/2] for positions 0..T-1, computed in float64."""
    from llm_inference_engine.ops.rope import _llama3_inv_freq_np
    D = cfg.head_dim
    inv = 1.0 / (float(cfg.rope_theta) ** (np.arange(D // 2) * 2.0 / D))
    rs = cfg.rope_scaling
    if isinstance(rs, (int, float)):
        inv = inv / float(rs)
    elif rs is not None:
        inv = _llama3_inv_freq_np(inv, rs)
    ang = np.arange(T, dtype=np.float64)[:, None] * inv[None, :]
    return (jnp.asarray(np.cos(ang), jnp.float32),
            jnp.asarray(np.sin(ang), jnp.float32))


def _rotate(x, cos, sin):
    """x [B, T, N, D]; cos/sin [T, D/2] — half-split pairing."""
    h = x.shape[-1] // 2
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., :h], x[..., h:]
    return jnp.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1)


def _f32_weight(w) -> jax.Array:
    """One layer's matmul weight as f32 [in, out] (gate|up stacks come out
    as the packed [in, gate | up] layout)."""
    if isinstance(w, QuantizedTensor):
        if w.q.ndim == 3:                     # [2, in', I] gate|up stack
            return jnp.concatenate(
                [dequantize_tensor(QuantizedTensor(
                    q=w.q[s], scale=w.scale[s], mode=w.mode,
                    group_size=w.group_size)) for s in (0, 1)], axis=-1)
        return dequantize_tensor(w)
    w = w.astype(jnp.float32)
    return w.reshape(w.shape[0], -1)


def _rms(x, w, eps):
    var = jnp.mean(jnp.square(x), axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(var + eps) * w.astype(jnp.float32)


def _mm(x, w):
    return jnp.einsum("bti,io->bto", x, w, precision=_HP)


def _int8_round_trip(x, scale_format: str):
    """x [B, T, K, D] through an int8 KV cache: per-(token, head) absmax
    scale over D, values rounded to [-127, 127]. ``scale_format``:
    "f32_scale" keeps the scale as is; "log2_scale" first rounds it to a
    1/256-octave step, as the paged pool stores it."""
    s = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True), 1e-30) / 127
    if scale_format == "log2_scale":
        s = jnp.exp2(jnp.round(jnp.log2(s) * 256) / 256)
    elif scale_format != "f32_scale":
        raise ValueError(f"unknown int8 KV scale format {scale_format!r}")
    return jnp.clip(jnp.round(x / s), -127, 127) * s


def reference_logits(cfg: ModelConfig, params, token_ids,
                     kv_int8: str | None = None) -> jax.Array:
    """token_ids [B, T] int32 -> logits [B, T, V] float32 at every position
    (causal, positions 0..T-1, sliding window when the config has one).
    ``kv_int8`` ("f32_scale" or "log2_scale"): keys and values take an int8
    cache's rounding before attention, as an engine with an int8 KV cache
    stores them."""
    token_ids = jnp.asarray(token_ids, jnp.int32)
    B, T = token_ids.shape
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    cos, sin = _rope_tables(cfg, T)
    i = jnp.arange(T)
    mask = i[None, :] <= i[:, None]                          # [Tq, Tk]
    if cfg.sliding_window is not None:
        mask = mask & (i[None, :] > i[:, None] - cfg.sliding_window)

    x = jnp.take(params["embed"], token_ids, axis=0).astype(jnp.float32)

    def layer(x, lp):
        h = _rms(x, lp["attn_norm"], cfg.rms_norm_eps)
        qkv = _mm(h, _f32_weight(lp["wqkv"]))
        if "bqkv" in lp:
            qkv = qkv + lp["bqkv"].astype(jnp.float32)
        z = qkv.reshape(B, T, K, G + 2, D)                   # group-major
        q = _rotate(z[:, :, :, :G].reshape(B, T, H, D), cos, sin)
        k = _rotate(z[:, :, :, G], cos, sin)
        v = z[:, :, :, G + 1]
        if kv_int8:
            k, v = _int8_round_trip(k, kv_int8), _int8_round_trip(v, kv_int8)
        s = jnp.einsum("bqkgd,bskd->bkgqs", q.reshape(B, T, K, G, D), k,
                       precision=_HP) / math.sqrt(D)
        s = jnp.where(mask, s, -jnp.inf)
        p = jax.nn.softmax(s, axis=-1)
        a = jnp.einsum("bkgqs,bskd->bqkgd", p, v, precision=_HP)
        x = x + _mm(a.reshape(B, T, H * D), _f32_weight(lp["wo"]))
        h = _rms(x, lp["ffn_norm"], cfg.rms_norm_eps)
        gu = _mm(h, _f32_weight(lp["w_gate_up"]))
        inter = gu.shape[-1] // 2
        act = jax.nn.silu(gu[..., :inter]) * gu[..., inter:]
        return x + _mm(act, _f32_weight(lp["w_down"])), None

    x, _ = jax.lax.scan(layer, x, params["layers"])
    x = _rms(x, params["final_norm"], cfg.rms_norm_eps)
    return _mm(x, _f32_weight(params["lm_head"]))
