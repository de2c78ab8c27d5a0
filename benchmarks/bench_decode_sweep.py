"""Decode throughput sweep: quant mode x KV dtype x model x batch.

Weight-only-quantized decode is bound by memory bandwidth: every step
streams the full weight set once regardless of batch, so tok/s scales with
batch until the KV-cache stream (linear in batch) dominates.

    python benchmarks/bench_decode_sweep.py                  # full matrix
    python benchmarks/bench_decode_sweep.py --model llama2-7b \
        --quant int4 --kv int8 --batches 1 8 16              # one config

Measurement (same as bench.py): two device-side rollouts of different
lengths from the same start state; dt = (t_long - t_short)/(n_long -
n_short). Differencing cancels the fixed per-call overhead (dispatch, the
final device-to-host copy); both rollouts share one compiled program (same
static kv watermark). The roofline's KV term uses the mean context of
exactly the differenced steps, and its bandwidth is the card's published
peak (benchmarks/device_peaks.py).

Prints one JSON line per config (same schema as bench.py), naming the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from device_peaks import peaks, require_gpu

STEPS_LO = 64
STEPS_HI = 320


def measure_config(model: str, quant: str, kv: str, batch: int,
                   prompt_len: int = 128, max_seq: int = 1024,
                   repeats: int = 3):
    """Measure one decode config; returns (tok_s, vs_roofline). The ONE
    measurement harness — bench.py's headline delegates here, so the
    differencing method, stall guard, and roofline accounting cannot
    drift between the two entry points (r4 review)."""
    import jax.numpy as jnp

    hbm_bw = peaks(require_gpu())["hbm_bytes_per_s"]
    from llm_inference_engine.config import EngineConfig, get_config
    from llm_inference_engine.models.weights import (
        init_dummy_params, init_dummy_quantized_params, param_bytes)
    from llm_inference_engine.runtime.engine import InferenceEngine

    cfg = get_config(model)
    if quant in ("int8", "int4"):
        params = init_dummy_quantized_params(cfg, mode=quant, seed=0)
    else:
        params = init_dummy_params(cfg, seed=0)
    wbytes = param_bytes(params)
    kv_itemsize = 1 if kv == "int8" else jnp.dtype(cfg.dtype).itemsize

    eng = EngineConfig(max_batch_size=batch, max_seq_len=max_seq,
                       quant_mode=quant, kv_cache_dtype_name=kv)
    engine = InferenceEngine(cfg, eng, params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()
               for _ in range(batch)]
    logits = engine.prefill(prompts)
    tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)

    kv_hi = engine._kv_watermark(np.full((batch,), prompt_len), STEPS_HI)

    def rollout(n):
        # fresh lengths each call: the donated cache consumes the buffer
        engine.cache = dataclasses.replace(
            engine.cache, lengths=jnp.full((batch,), prompt_len, jnp.int32))
        toks, engine.cache = engine._rollout_fn(
            engine.params, engine.cache, tokens, n, kv_hi=kv_hi)
        return np.asarray(toks[-1])        # device-to-host fence

    best = {}
    for n in (STEPS_LO, STEPS_HI):
        _ = rollout(n)
        b = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            _ = rollout(n)
            b = min(b, time.perf_counter() - t0)
        best[n] = b
    dt = (best[STEPS_HI] - best[STEPS_LO]) / (STEPS_HI - STEPS_LO)
    if dt <= 0:  # a host stall polluted every LO repeat: fall back to
        dt = best[STEPS_HI] / STEPS_HI          # the long window alone
    tok_s = batch / dt

    avg_ctx = prompt_len + (STEPS_LO + STEPS_HI - 1) / 2
    kv_extra = 4 if kv == "int8" else 0    # per-(token, head) f32 scale
    kv_bytes = (cfg.num_layers * 2 * cfg.num_kv_heads * avg_ctx
                * (cfg.head_dim * kv_itemsize + kv_extra) * batch)
    roofline = batch / ((wbytes + kv_bytes) / hbm_bw)
    del engine, params
    return tok_s, tok_s / roofline


def bench_config(model: str, quant: str, kv: str, batch: int,
                 prompt_len: int, max_seq: int, repeats: int):
    from device_peaks import card_identity
    tok_s, ratio = measure_config(model, quant, kv, batch, prompt_len,
                                  max_seq, repeats)
    print(json.dumps({
        "metric": (f"decode_tokens_per_sec_{model}"
                   f"_{quant}_kv{kv or 'native'}_bs{batch}"),
        "value": tok_s,
        "unit": "tok/s",
        "vs_baseline": ratio,
        "device": card_identity(require_gpu()),
    }), flush=True)


# (model, quant, kv_dtype, batches)
MATRIX = [
    ("llama2-7b", "int4", "", [8]),
    ("llama2-7b", "int4", "int8", [1, 8, 16]),
    ("llama2-7b", "int8", "", [8]),
    ("llama2-7b", "int8", "int8", [8]),
    ("llama2-13b", "int4", "int8", [8]),
    ("tinyllama-1.1b", "", "", [8]),      # bf16
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None)
    ap.add_argument("--quant", default="int4")
    ap.add_argument("--kv", default="int8")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 16])
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    runs = ([(args.model, args.quant, args.kv, args.batches)]
            if args.model else MATRIX)
    for model, quant, kv, batches in runs:
        for batch in batches:
            bench_config(model, quant, kv, batch, args.prompt_len,
                         args.max_seq, args.repeats)


if __name__ == "__main__":
    main()
