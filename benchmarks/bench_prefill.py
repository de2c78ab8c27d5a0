"""Batched prefill throughput benchmark (prompt tokens/sec).

TTFT (bench_ttft.py) measures the latency of ONE prompt; this measures the
serving-side question — how many prompt tokens per second one card can
ingest at batch. Prefill is compute-bound, unlike decode (memory), so
``vs_baseline`` is the fraction of the card's published bf16 tensor-core
peak (benchmarks/device_peaks.py) achieved:

    flops/token ~= 2 * (matmul params) + attention score/value FLOPs
    roofline tok/s = peak_flops / flops_per_token

    python benchmarks/bench_prefill.py [--model llama2-7b] [--quant int8]
                                       [--batch 4] [--len 512]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from device_peaks import card_identity, peaks, require_gpu


def matmul_flops_per_token(cfg, ctx_len: int) -> float:
    """2*params for every matmul a prefill token passes through, plus the
    quadratic attention term at the mean context length seen during the
    prompt (ctx_len/2)."""
    H = cfg.hidden_size
    hd = cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    I = cfg.intermediate_size
    per_layer = (H * nq * hd          # q proj
                 + 2 * H * nkv * hd   # k,v proj
                 + nq * hd * H        # o proj
                 + 3 * H * I)         # gate, up, down
    params = cfg.num_layers * per_layer + H * cfg.vocab_size  # + lm head
    attn = cfg.num_layers * 2 * 2 * nq * hd * (ctx_len / 2)   # qk^T + pv
    return 2 * params + attn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--quant", default="int8")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--len", type=int, dest="plen", default=512)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    device = require_gpu()
    peak_flops = peaks(device)["bf16_flops"]
    from llm_inference_engine.config import EngineConfig, get_config
    from llm_inference_engine.models.weights import (
        init_dummy_params, init_dummy_quantized_params)
    from llm_inference_engine.runtime.engine import InferenceEngine

    cfg = get_config(args.model)
    eng = EngineConfig(max_batch_size=args.batch,
                       max_seq_len=2 * args.plen,
                       quant_mode=args.quant)
    if args.quant in ("int8", "int4"):
        params = init_dummy_quantized_params(cfg, mode=args.quant, seed=0)
    else:
        params = init_dummy_params(cfg, seed=0)
    engine = InferenceEngine(cfg, eng, params)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=args.plen).tolist()
               for _ in range(args.batch)]

    # warmup / compile (covers every chunk-shape variant of this config)
    engine.reset()
    logits = engine.prefill(prompts)
    _ = np.asarray(logits[-1, -8:])  # device-to-host fence

    best_dt = float("inf")
    for _ in range(args.repeats):
        engine.reset()
        t0 = time.perf_counter()
        logits = engine.prefill(prompts)
        _ = np.asarray(logits[-1, -8:])
        best_dt = min(best_dt, time.perf_counter() - t0)

    tokens = args.batch * args.plen
    tok_per_sec = tokens / best_dt
    roofline = peak_flops / matmul_flops_per_token(cfg, args.plen)

    print(json.dumps({
        "metric": (f"prefill_tokens_per_sec_{args.model}"
                   f"_{args.quant}_bs{args.batch}_len{args.plen}"),
        "value": tok_per_sec,
        "unit": "tok/s",
        "vs_baseline": tok_per_sec / roofline,
        "device": card_identity(device),
    }))


if __name__ == "__main__":
    main()
