"""Time-to-first-token (prefill latency) benchmark.

BASELINE.md tracks p50 TTFT per config. Measures the full first-token
path — tokenized prompt in, sampled first token id out — for Llama2-7B
INT8 on the attached GPU at several prompt lengths. Prints one JSON line
per length:

    python benchmarks/bench_ttft.py [--batch 1] [--model llama2-7b]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--quant", default="int8")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--lens", type=int, nargs="+",
                    default=[128, 512, 1024])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    from llm_inference_engine.config import EngineConfig, get_config
    from llm_inference_engine.models.weights import (
        init_dummy_quantized_params, init_dummy_params)
    from llm_inference_engine.runtime.engine import InferenceEngine

    cfg = get_config(args.model)
    eng = EngineConfig(max_batch_size=args.batch,
                       max_seq_len=max(args.lens) * 2,
                       quant_mode=args.quant)
    if args.quant in ("int8", "int4"):
        params = init_dummy_quantized_params(cfg, mode=args.quant, seed=0)
    else:
        params = init_dummy_params(cfg, seed=0)
    engine = InferenceEngine(cfg, eng, params)

    rng = np.random.default_rng(0)
    for plen in args.lens:
        prompts = [rng.integers(1, cfg.vocab_size, size=plen).tolist()
                   for _ in range(args.batch)]
        # warmup/compile
        engine.reset()
        logits = engine.prefill(prompts)
        tok = engine.sample(logits, jnp.zeros((args.batch,)),
                            jnp.ones((args.batch,), jnp.int32),
                            jnp.ones((args.batch,)))
        _ = np.asarray(tok)

        times = []
        for _ in range(args.repeats):
            engine.reset()
            t0 = time.perf_counter()
            logits = engine.prefill(prompts)
            tok = engine.sample(logits, jnp.zeros((args.batch,)),
                                jnp.ones((args.batch,), jnp.int32),
                                jnp.ones((args.batch,)))
            _ = np.asarray(tok)        # D2H fence: first token on host
            times.append(time.perf_counter() - t0)
        p50 = float(np.percentile(times, 50))
        print(json.dumps({
            "metric": f"ttft_p50_{args.model}_{args.quant}"
                      f"_bs{args.batch}_len{plen}",
            "value": round(p50 * 1e3, 2),
            "unit": "ms",
            "tok_per_s_prefill": round(plen * args.batch / p50, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
