#!/usr/bin/env python3
"""One-command WikiText-2 perplexity gate (BASELINE.md acceptance table).

Usage, once a real checkpoint + corpus exist on the machine:

    python tools/run_ppl.py --checkpoint /path/to/hf-llama2-7b \
        --data /path/to/wikitext-2-test.txt --quant compare

prints one JSON line with fp/int8/int4 PPL and deltas; the gate passes when
int8_delta <= 0.1 and int4_delta <= 0.5.

This is a thin entry point over ``llm_inference_engine.evals.ppl`` — the
harness itself (windowed teacher-forced scoring, device-side NLL) lives
there and is unit-tested. No checkpoint or corpus ships with the repo; the
proxy that needs neither is the synthetic-statistics logits-divergence
tool (tools/quant_divergence.py), not yet run on the GPU.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llm_inference_engine.evals.ppl import main

if __name__ == "__main__":
    main()
