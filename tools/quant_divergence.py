#!/usr/bin/env python3
"""Quantization quality proxy at real 7B shapes: fp-vs-quant logits divergence.

BASELINE.md's quality gate is WikiText-2 PPL delta (<=0.1 INT8, <=0.5 INT4);
no Llama checkpoint or corpus exists in this environment, so the gate itself
cannot produce numbers here (tools/run_ppl.py is the one-command runner for
when assets exist). This tool records the strongest evidence available
without assets: run the FULL 7B model end-to-end on the attached GPU with
synthetic weights whose per-channel statistics mimic what makes real LLM
weights hard to quantize, and measure how far INT8/INT4 push the logits
off the fp baseline.

Weight synthesis (documented so the numbers are reproducible):
- body: w[i, j] ~ N(0, s_j^2) with per-output-channel scales
  s_j ~ LogNormal(ln(base), 0.35), base = 1/sqrt(fan_in) — real transformer
  weight matrices show exactly this kind of channel-scale spread;
- outliers: 0.5% of output channels get 8x scale (the LLM.int8()
  observation — absmax per-channel scales are stressed by outlier channels,
  which is what separates int8's per-channel scheme from int4's grouped one);
- norms at 1.0, embeddings at 0.02 std (HF init convention).

Metrics per quant mode, over B x T teacher-forced positions:
- mean/max |delta logit| and the fp logit std (the perturbation only matters
  relative to the logit spread);
- top-1 agreement (did quantization flip the argmax);
- mean KL(fp || quant) in nats — the quantity a PPL delta integrates, so it
  is the most direct proxy for the PPL gate;
- mean |delta log p| on the fp-argmax token.

Memory plan: weights are synthesized per-tensor on host (numpy), quantized
on host with the same math as ops/quant.quantize_tensor, and only one
variant's parameters ever live on device (fp bf16 is ~13.5 GB).

Run: python tools/quant_divergence.py [--model llama2-7b] [--batch 4]
     [--window 512] | tee chiprun_out/quant_divergence.log
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synth_weight(rng: np.random.Generator, fan_in: int, shape,
                 outlier_frac: float = 0.005, outlier_gain: float = 8.0):
    """[..., out] fp32 weight with lognormal per-channel scales + outliers."""
    out = shape[-1]
    base = 1.0 / np.sqrt(fan_in)
    s = np.exp(rng.normal(np.log(base), 0.35, size=out)).astype(np.float32)
    n_out = max(1, int(out * outlier_frac))
    idx = rng.choice(out, size=n_out, replace=False)
    s[idx] *= outlier_gain
    w = rng.standard_normal(shape, dtype=np.float32)
    return w * s


def synth_params_np(cfg, seed: int = 0):
    """Full parameter set as host numpy fp32 (never on device)."""
    rng = np.random.default_rng(seed)
    L, Hd = cfg.num_layers, cfg.hidden_size
    p = {
        "embed": (rng.standard_normal((cfg.vocab_size, Hd), dtype=np.float32)
                  * 0.02),
        "layers": {
            "attn_norm": np.ones((L, Hd), np.float32),
            "wqkv": synth_weight(rng, Hd, (L, Hd, cfg.qkv_size)),
            "wo": synth_weight(rng, cfg.q_size, (L, cfg.q_size, Hd)),
            "ffn_norm": np.ones((L, Hd), np.float32),
            "w_gate_up": synth_weight(rng, Hd,
                                      (L, Hd, 2, cfg.intermediate_size)),
            "w_down": synth_weight(rng, cfg.intermediate_size,
                                   (L, cfg.intermediate_size, Hd)),
        },
        "final_norm": np.ones((Hd,), np.float32),
        "lm_head": synth_weight(rng, Hd, (Hd, cfg.vocab_size)),
    }
    return p


def quantize_np(w: np.ndarray, mode: str, group_size: int = 128):
    """Host-side mirror of ops/quant.quantize_tensor (absmax symmetric).
    w: [in, out] -> (q, scale) in QuantizedTensor's per-layer layout
    (int8: q [in, out] + scale [1, out]; int4: q [in/2, out] packed with
    the sublane interleave + scale [in/group, out])."""
    if mode == "int8":
        absmax = np.abs(w).max(axis=0, keepdims=True)
        scale = np.maximum(absmax, 1e-8) / 127.0
        q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        return q, scale.astype(np.float32)
    k, n = w.shape
    g = k // group_size
    wg = w.reshape(g, group_size, n)
    absmax = np.abs(wg).max(axis=1, keepdims=True)
    scale = np.maximum(absmax, 1e-8) / 7.0
    q = np.clip(np.round(wg / scale), -8, 7).astype(np.int8).reshape(k, n)
    lo = q[0::2].astype(np.uint8) & 0xF
    hi = (q[1::2].astype(np.uint8) & 0xF) << 4
    packed = (lo | hi).astype(np.int8)
    return packed, scale[:, 0, :].astype(np.float32)


def search_clip_np(w: np.ndarray, group_size: int,
                   act_sq: np.ndarray | None = None,
                   grid=tuple(1.0 - 0.05 * i for i in range(11))):
    """Host-side mirror of ops.quant.search_clip (int4): per-group clip
    factors minimizing activation-weighted weight MSE."""
    k, n = w.shape
    g = group_size
    wg = w.reshape(k // g, g, n)
    d = (np.ones((k,), np.float32) if act_sq is None
         else act_sq.astype(np.float32))
    dg = d.reshape(k // g, g, 1)
    absmax = np.maximum(np.abs(wg).max(axis=1, keepdims=True), 1e-8)
    best_err = None
    best_clip = None
    for alpha in grid:
        scale = absmax * alpha / 7.0
        q = np.clip(np.round(wg / scale), -8, 7)
        err = (dg * (wg - q * scale) ** 2).sum(axis=1)      # [G, N]
        if best_err is None:
            best_err, best_clip = err, np.full_like(err, alpha)
        else:
            take = err < best_err
            best_err = np.where(take, err, best_err)
            best_clip = np.where(take, alpha, best_clip)
    return best_clip


def quantize_np_cal(w: np.ndarray, group_size: int,
                    act_sq: np.ndarray | None):
    """int4 with the clip factors applied (mirror of
    quantize_tensor(..., clip=search_clip(...)))."""
    k, n = w.shape
    g = k // group_size
    clip = search_clip_np(w, group_size, act_sq)
    wg = w.reshape(g, group_size, n)
    absmax = np.maximum(np.abs(wg).max(axis=1, keepdims=True), 1e-8)
    absmax = absmax * clip.reshape(g, 1, n)
    scale = np.maximum(absmax, 1e-8) / 7.0
    q = np.clip(np.round(wg / scale), -8, 7).astype(np.int8).reshape(k, n)
    lo = q[0::2].astype(np.uint8) & 0xF
    hi = (q[1::2].astype(np.uint8) & 0xF) << 4
    packed = (lo | hi).astype(np.int8)
    return packed, scale[:, 0, :].astype(np.float32)


def quantize_stacked_np(w: np.ndarray, mode: str, group_size: int,
                        act_sq: np.ndarray | None = None):
    """Host-side mirror of models/weights.quantize_params for one stacked
    weight: [L, in, out] -> (q [L, ...], s [L, ...]); the structured
    gate|up stack [L, in, 2, I] -> ([L, 2, in', I], [L, 2, G|1, I]).
    mode "int4cal": int4 with calibration-aware clip search (act_sq
    [L, in] or None for plain MSE clipping)."""
    structured = w.ndim == 4
    if structured:
        w = w.reshape(w.shape[0], w.shape[1], -1)
    qs, ss = [], []
    for l in range(w.shape[0]):
        if mode == "int4cal":
            q, s = quantize_np_cal(
                w[l], group_size, None if act_sq is None else act_sq[l])
        else:
            q, s = quantize_np(w[l], mode, group_size)
        if structured:
            q = q.reshape(q.shape[0], 2, -1).transpose(1, 0, 2)
            s = s.reshape(s.shape[0], 2, -1).transpose(1, 0, 2)
        qs.append(q)
        ss.append(s)
    return np.stack(qs), np.stack(ss)


def build_device_params(np_params, cfg, mode: str, group_size: int,
                        act_sq=None):
    """Move one variant to device: fp -> bf16 leaves; int8/int4 ->
    QuantizedTensor leaves in the exact pytree layout of
    models/weights.quantize_params (incl. the quantized lm_head the
    serving engine defaults to). mode "int4cal" = int4 storage with
    calibration-aware clip search (runtime-identical to int4)."""
    import jax.numpy as jnp
    from llm_inference_engine.ops.quant import QuantizedTensor

    store_mode = "int4" if mode == "int4cal" else mode

    def dev(x, dtype=jnp.bfloat16):
        return jnp.asarray(x, dtype)

    def qt(q, s):
        return QuantizedTensor(q=dev(q, jnp.int8), scale=dev(s, jnp.float32),
                               mode=store_mode, group_size=group_size)

    lay = np_params["layers"]
    layers = {"attn_norm": dev(lay["attn_norm"]),
              "ffn_norm": dev(lay["ffn_norm"])}
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        w = lay[name]
        if mode == "fp":
            layers[name] = dev(w)
        else:
            d = None if act_sq is None else act_sq.get(name)
            layers[name] = qt(*quantize_stacked_np(w, mode, group_size, d))
    if mode == "fp":
        lm_head = dev(np_params["lm_head"])
    elif mode == "int4cal":
        lm_head = qt(*quantize_np_cal(np_params["lm_head"], group_size,
                                      None))
    else:
        lm_head = qt(*quantize_np(np_params["lm_head"], mode, group_size))
    return {
        "embed": dev(np_params["embed"]),
        "layers": layers,
        "final_norm": dev(np_params["final_norm"]),
        "lm_head": lm_head,
    }


def calibrate(cfg, np_params, args) -> dict:
    """Activation second moments for int4cal (models.weights.
    calibrate_act_sq — the real fp forward with debug taps, i.e. host
    callbacks) over ``args.calib_tokens`` tokens: {wqkv, wo, w_gate_up,
    w_down}: [L, in]."""
    import jax.numpy as jnp

    from llm_inference_engine.models.weights import calibrate_act_sq
    params = {"embed": jnp.asarray(np_params["embed"]),
              "layers": {k: jnp.asarray(v)
                         for k, v in np_params["layers"].items()},
              "final_norm": jnp.asarray(np_params["final_norm"]),
              "lm_head": jnp.asarray(np_params["lm_head"])}
    rng = np.random.default_rng(args.seed + 1)
    toks = rng.integers(0, cfg.vocab_size,
                        size=(1, args.calib_tokens)).astype(np.int32)
    act = calibrate_act_sq(cfg, params, [toks])
    del params
    return {k: np.asarray(v) for k, v in act.items()}


def run_variant(cfg, eng, np_params, tokens, mode: str, group_size: int,
                act_sq=None):
    """Forward the whole [B, T] batch; return host fp32 logits [B, T, V]."""
    import jax
    import jax.numpy as jnp
    from llm_inference_engine.models import llama as llama_model
    from llm_inference_engine.ops import kv_cache as kvc

    B, T = tokens.shape
    params = build_device_params(np_params, cfg, mode, group_size, act_sq)
    cache = kvc.new_kv_cache(cfg.num_layers, B, cfg.num_kv_heads, T,
                             cfg.head_dim, dtype=cfg.dtype)
    q_start = jnp.zeros((B,), jnp.int32)
    kv_len = jnp.full((B,), T, jnp.int32)

    @jax.jit
    def fwd(params, cache, toks):
        logits, _ = llama_model.forward_all_logits(
            cfg, eng, params, toks, cache, q_start, kv_len)
        return logits.astype(jnp.float32)

    t0 = time.time()
    out = np.asarray(fwd(params, cache, jnp.asarray(tokens)))
    dt = time.time() - t0
    # free this variant's device buffers before the next one stages
    del params, cache
    import gc
    gc.collect()
    return out, dt


def divergence(fp: np.ndarray, q: np.ndarray):
    """fp, q: [B, T, V] fp32 logits -> metric dict."""
    d = np.abs(q - fp)
    fp_arg = fp.argmax(-1)
    q_arg = q.argmax(-1)
    # log-softmax on host in float64 for a stable KL
    def logsoft(x):
        x = x.astype(np.float64)
        m = x.max(-1, keepdims=True)
        z = x - m
        return z - np.log(np.exp(z).sum(-1, keepdims=True))
    lp_fp = logsoft(fp)
    lp_q = logsoft(q)
    kl = (np.exp(lp_fp) * (lp_fp - lp_q)).sum(-1)        # [B, T]
    take = np.take_along_axis
    dlogp_top1 = np.abs(
        take(lp_fp, fp_arg[..., None], -1)
        - take(lp_q, fp_arg[..., None], -1))[..., 0]
    return {
        "mean_abs_dlogit": float(d.mean()),
        "max_abs_dlogit": float(d.max()),
        "fp_logit_std": float(fp.std()),
        "top1_agreement": float((fp_arg == q_arg).mean()),
        "mean_kl_nats": float(kl.mean()),
        "p99_kl_nats": float(np.percentile(kl, 99)),
        "mean_abs_dlogp_top1": float(dlogp_top1.mean()),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--modes", default="int8,int4,int4cal",
                    help="int4cal = int4 with calibration-aware clip "
                         "search (AWQ-lite) — same runtime "
                         "kernels, different scales")
    ap.add_argument("--calib-tokens", type=int, default=64,
                    help="calibration forward length for int4cal")
    ap.add_argument("--platform", default=None,
                    help="jax platform override (e.g. cpu)")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from llm_inference_engine.config import EngineConfig, get_config

    cfg = get_config(args.model)
    eng = EngineConfig(max_batch_size=args.batch, max_seq_len=args.window)

    print(f"# quant divergence proxy — {args.model} shapes, "
          f"B={args.batch} T={args.window}, backend={jax.default_backend()} "
          f"devices={jax.devices()}", flush=True)
    print("# synthesizing host weights (lognormal channel scales, 0.5% "
          "outlier channels at 8x)...", flush=True)
    np_params = synth_params_np(cfg, args.seed)
    rng = np.random.default_rng(args.seed + 1)
    tokens = rng.integers(0, cfg.vocab_size,
                          size=(args.batch, args.window)).astype(np.int32)

    fp_logits, dt = run_variant(cfg, eng, np_params, tokens, "fp",
                                args.group_size)
    print(f"# fp forward done in {dt:.1f}s (incl. compile + staging)",
          flush=True)

    report = {"model": args.model, "batch": args.batch,
              "window": args.window, "group_size": args.group_size,
              "positions": int(tokens.size),
              "backend": jax.default_backend()}
    for mode in args.modes.split(","):
        act_sq = None
        if mode == "int4cal":
            print(f"# calibrating activation stats "
                  f"({args.calib_tokens} tokens)...", flush=True)
            act_sq = calibrate(cfg, np_params, args)
            print("# int4cal: activation-weighted clip search", flush=True)
        q_logits, dt = run_variant(cfg, eng, np_params, tokens, mode,
                                   args.group_size, act_sq)
        report[mode] = divergence(fp_logits, q_logits)
        print(f"# {mode} forward done in {dt:.1f}s", flush=True)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
