"""Serving-load benchmark: continuous batching under a Poisson arrival stream.

Drives ContinuousBatchingScheduler (runtime/scheduler.py) with open-loop
request arrivals — the serving regime the reference could never enter
(bs=1, llama.h:31) — and reports request throughput, output tok/s, and
TTFT / end-to-end latency percentiles.

    python benchmarks/bench_serving.py                     # GPU, llama2-7b int8
    python benchmarks/bench_serving.py --model debug \
        --platform cpu --requests 24 --rate 50             # CPU smoke

Open-loop means arrivals do not wait for completions: at --rate R req/s the
benchmark reveals whether the scheduler keeps up (queue drains) or saturates
(TTFT grows with queue depth).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--quant", default="int8",
                    choices=["none", "int8", "int4"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="mean arrival rate, req/s (Poisson)")
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--draft-model", default="",
                    help="speculative serving: draft model preset "
                         "(dummy weights; greedy rounds of --num-draft)")
    ap.add_argument("--num-draft", type=int, default=4)
    ap.add_argument("--kv-layout", default="slot", choices=["slot", "paged"])
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="paged pool size (0 = slot-equivalent); a large "
                         "--batch with a bounded pool is the paged win: "
                         "concurrency limited by tokens, not slots")
    ap.add_argument("--platform", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from llm_inference_engine.config import (EngineConfig, SamplingParams,
                                                 get_config)
    from llm_inference_engine.models.registry import create_dummy_engine
    from llm_inference_engine.runtime.scheduler import (
        ContinuousBatchingScheduler)

    cfg = get_config(args.model)
    eng = EngineConfig(max_batch_size=args.batch,
                       max_seq_len=args.max_seq_len,
                       quant_mode=args.quant,
                       kv_layout=args.kv_layout,
                       page_size=args.page_size,
                       num_pages=args.num_pages)
    engine = create_dummy_engine(args.model, eng, seed=args.seed)
    if args.draft_model:
        if args.kv_layout == "paged":
            ap.error("--draft-model requires --kv-layout slot")
        from llm_inference_engine.runtime.speculative_scheduler import (
            SpeculativeScheduler)
        # a different seed: identical dummy weights would pin acceptance
        # at 100% and measure a speedup no deployment could see
        draft = create_dummy_engine(args.draft_model, eng,
                                    seed=args.seed + 1)
        sched = SpeculativeScheduler(engine, draft, eos_token_id=None,
                                     num_draft=args.num_draft)
    else:
        sched = ContinuousBatchingScheduler(engine, eos_token_id=None)

    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    prompts = [rng.integers(3, cfg.vocab_size,
                            size=args.prompt_len).tolist()
               for _ in range(args.requests)]
    sampling = SamplingParams(greedy=True, max_new_tokens=args.new_tokens)

    # warmup: compile prefill + decode step shapes before the clock starts
    w = sched.submit(prompts[0][: args.prompt_len], sampling)
    while sched.has_work:
        sched.step()
    w.output_ids.clear()

    t_first: dict[int, float] = {}
    t_done: dict[int, float] = {}
    t_submit: dict[int, float] = {}

    t0 = time.perf_counter()
    next_arrival = 0
    finished = 0
    while finished < args.requests:
        now = time.perf_counter() - t0
        while (next_arrival < args.requests
               and arrivals[next_arrival] <= now):
            i = next_arrival

            def cb(tok, i=i):
                t_first.setdefault(i, time.perf_counter() - t0)

            r = sched.submit(prompts[i], sampling, stream_callback=cb)
            r.bench_index = i
            t_submit[i] = arrivals[i]
            next_arrival += 1
        if not sched.has_work:
            # idle until the next arrival
            time.sleep(max(0.0, arrivals[next_arrival] - now))
            continue
        for r in sched.step():
            t_done[r.bench_index] = time.perf_counter() - t0
            finished += 1
    wall = time.perf_counter() - t0

    ttft = np.array([t_first[i] - t_submit[i] for i in range(args.requests)])
    e2e = np.array([t_done[i] - t_submit[i] for i in range(args.requests)])
    out_toks = args.requests * args.new_tokens
    result = {
        "metric": f"serving_{args.model}_{args.quant}_bs{args.batch}",
        "requests": args.requests,
        "offered_rate_rps": args.rate,
        "achieved_rps": round(args.requests / wall, 3),
        "output_tok_per_s": round(out_toks / wall, 1),
        "ttft_p50_ms": round(float(np.percentile(ttft, 50)) * 1e3, 1),
        "ttft_p95_ms": round(float(np.percentile(ttft, 95)) * 1e3, 1),
        "e2e_p50_ms": round(float(np.percentile(e2e, 50)) * 1e3, 1),
        "e2e_p95_ms": round(float(np.percentile(e2e, 95)) * 1e3, 1),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
