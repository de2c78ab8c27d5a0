"""Benchmark: Llama2-7B INT4 weight-only decode throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "tok/s", "vs_baseline": N,
   "device": {"platform", "kind", "nvidia_smi"}}

The reference publishes no numbers (BASELINE.md: it could not even load
Llama2-7B), so ``vs_baseline`` is the fraction of the memory-bandwidth
roofline achieved: a weight-only-quantized decode step is bound by
streaming the weights + KV cache once per token; roofline tok/s =
batch / (bytes_moved / peak_bandwidth), with the card's published peak
(benchmarks/device_peaks.py; an unknown card is an error).

The measurement harness lives in benchmarks/bench_decode_sweep.py
(measure_config) and is shared with the full sweep: two device-side
rollouts of different lengths from the same start state, differenced to
cancel fixed per-call overhead, with the roofline's KV term charged at the
mean context of exactly the differenced steps.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "benchmarks"))

MODEL = "llama2-7b"
QUANT = "int4"
BATCH = 8


def main():
    from bench_decode_sweep import measure_config
    from device_peaks import card_identity, require_gpu

    from llm_inference_engine.utils.compile_cache import enable_compile_cache

    device = require_gpu()
    enable_compile_cache()
    tok_s, ratio = measure_config(MODEL, QUANT, kv="", batch=BATCH)
    print(json.dumps({
        "metric": f"decode_tokens_per_sec_{MODEL}_{QUANT}_bs{BATCH}",
        "value": tok_s,
        "unit": "tok/s",
        "vs_baseline": ratio,
        "device": card_identity(device),
    }))


if __name__ == "__main__":
    main()
