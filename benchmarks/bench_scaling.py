"""Scaling-efficiency harness: sharded decode throughput at a (dp, tp)
mesh, with per-card efficiency against a one-card reference:

    python benchmarks/bench_scaling.py                 # one card (ref)
    python benchmarks/bench_scaling.py --dp 1 --tp 4   # four cards, TP
    python benchmarks/bench_scaling.py --dp 4 \
        --ref-tok-s 646                                # vs stored ref

One process drives all the cards of the mesh (a second process on a card
would fail for want of device memory). Prints one JSON line: {"metric",
"value" (tok/s), "unit", "per_device", "efficiency_vs_one_device"}. The sharding itself is validated without accelerators by the
8-virtual-device CPU tests and __graft_entry__.dryrun_multichip.
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
    ap.add_argument("--quant", default="int4")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--batch-per-replica", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--rollout", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--ref-tok-s", type=float, default=None,
                    help="one-card tok/s to compute scaling efficiency")
    args = ap.parse_args()

    from llm_inference_engine.config import EngineConfig, get_config
    from llm_inference_engine.models.weights import (
        init_dummy_params, init_dummy_quantized_params)
    from llm_inference_engine.runtime.engine import InferenceEngine

    n_dev = args.dp * args.tp
    if len(jax.devices()) < n_dev:
        raise SystemExit(
            f"need {n_dev} devices for dp={args.dp} tp={args.tp}, have "
            f"{len(jax.devices())}")

    cfg = get_config(args.model)
    batch = args.batch_per_replica * args.dp
    eng = EngineConfig(max_batch_size=batch, max_seq_len=1024,
                       quant_mode=args.quant, dp=args.dp, tp=args.tp)
    if args.quant in ("int8", "int4"):
        params = init_dummy_quantized_params(cfg, mode=args.quant, seed=0)
    else:
        params = init_dummy_params(cfg, seed=0)
    engine = InferenceEngine(cfg, eng, params)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len).tolist()
               for _ in range(batch)]
    logits = engine.prefill(prompts)
    tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks = engine.decode_rollout(tokens, args.rollout)
    _ = np.asarray(toks[-1])

    best = float("inf")
    for _ in range(args.repeats):
        last = toks[-1]
        t0 = time.perf_counter()
        toks = engine.decode_rollout(last, args.rollout)
        _ = np.asarray(toks[-1])
        best = min(best, time.perf_counter() - t0)

    tok_s = batch * args.rollout / best
    per_device = tok_s / n_dev
    eff = (per_device / args.ref_tok_s) if args.ref_tok_s else None
    print(json.dumps({
        "metric": (f"decode_tokens_per_sec_{args.model}_{args.quant}"
                   f"_dp{args.dp}_tp{args.tp}_bs{batch}"),
        "value": round(tok_s, 2),
        "unit": "tok/s",
        "per_device": round(per_device, 2),
        "efficiency_vs_one_device":
            round(eff, 4) if eff is not None else None,
    }))


if __name__ == "__main__":
    main()
