"""Where an engine step's device time goes: a jax.profiler trace of one
prefill call and of a device-side decode rollout (Llama-2-7B, batch 8,
max_seq_len 2048), reduced to device time per XLA op.

    XLA_FLAGS=--xla_gpu_enable_command_buffer= \
        python benchmarks/profile_step.py [--quant int4] [--plain]

Without that flag XLA groups a step's kernels into command buffers and the
trace shows those instead of the ops. Output goes to chiprun_out/profile.

For each window it prints the wall time, the union of device busy time
(and the idle share of the window), and the ops that take the most device
time, with the JAX op path each came from. Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from device_peaks import card_identity, require_gpu


def device_op_times(xplane_path: str):
    """(per-op {hlo_op: [total_ns, count, op_path]}, busy_ns, span_ns)
    over the device planes of one trace. Busy is the union of the op
    intervals."""
    from jax.profiler import ProfileData
    ops: dict = {}
    intervals = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if "/device:GPU" not in plane.name:
            continue
        lines = {ln.name: ln for ln in plane.lines}
        use = [lines["XLA Ops"]] if "XLA Ops" in lines else [
            ln for name, ln in lines.items() if name.startswith("Stream")]
        for ln in use:
            for ev in ln.events:
                stats = dict(ev.stats)
                key = stats.get("hlo_op", ev.name)
                path = stats.get("tf_op", stats.get("long_name", ""))
                rec = ops.setdefault(key, [0.0, 0, str(path)[:160]])
                rec[0] += ev.duration_ns
                rec[1] += 1
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    intervals.sort()
    busy, end, start = 0.0, None, None
    for s, e in intervals:
        start = s if start is None else start
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    span = (end - start) if intervals else 0.0
    return ops, busy, span


def report(label: str, trace_dir: str, wall: float, steps: int, top: int,
           out: str | None):
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    ops, busy, span = device_op_times(sorted(paths)[-1])
    lines = [f"{label}: wall {wall * 1e3:.3f} ms for {steps} step(s); "
             f"device busy {busy / 1e6:.3f} ms over a {span / 1e6:.3f} ms "
             f"device span (idle share of wall "
             f"{max(0.0, 1 - busy / 1e9 / wall):.3f})"]
    ranked = sorted(ops.items(), key=lambda kv: -kv[1][0])
    for name, (ns, n, path) in ranked[:top]:
        lines.append(f"  {ns / 1e3 / steps:10.1f} us/step  x{n / steps:6.1f}"
                     f"  {ns / max(busy, 1):6.3f}  {name}  {path}")
    text = "\n".join(lines)
    print(text, flush=True)
    if out:
        with open(out + f"_{label.replace(' ', '_')}.txt", "w") as f:
            f.write(text + "\n")
            for name, (ns, n, path) in ranked:
                f.write(f"{ns:.0f}\t{n}\t{name}\t{path}\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quant", default="int4")
    ap.add_argument("--plain", action="store_true",
                    help="every op plain XLA: no int4 kernel, no cuDNN "
                         "prefill (default: the shipped routing)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args()
    device = require_gpu()
    ident = card_identity(device)
    print(f"card: {ident}", flush=True)

    from llm_inference_engine.config import EngineConfig
    from llm_inference_engine.models.registry import create_engine
    from llm_inference_engine.ops import quant as Q
    from llm_inference_engine.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.plain:
        from llm_inference_engine.ops import attention as A
        Q.INT4_KERNEL_MAX_ROWS = 0
        A._use_cudnn = lambda q: False

    engine = create_engine("llama2-7b", None, EngineConfig(
        max_batch_size=8, max_seq_len=2048, quant_mode=args.quant))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, 32000, size=512).tolist() for _ in range(8)]
    logits = engine.prefill(prompts)                 # compile + warm
    jax.block_until_ready(logits)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    kv_hi = engine._kv_watermark(np.full((8,), 512), args.steps)

    def rollout():
        engine.cache = dataclasses.replace(
            engine.cache, lengths=jnp.full((8,), 512, jnp.int32))
        toks, engine.cache = engine._rollout_fn(engine.params, engine.cache,
                                                tok, args.steps, kv_hi=kv_hi)
        return np.asarray(toks[-1])
    rollout()                                        # compile + warm
    tag = f"{args.quant}_{'plain' if args.plain else 'shipped'}"
    out = os.path.join(args.out, tag)
    os.makedirs(args.out, exist_ok=True)

    for label, fn, steps in (
            (f"prefill 8x512 {tag}", lambda: jax.block_until_ready(
                engine.prefill(prompts)), 1),
            (f"decode rollout {tag}", rollout, args.steps)):
        if label.startswith("prefill"):
            engine.reset()
        d = os.path.join(args.out, "trace_" + label.replace(" ", "_"))
        with jax.profiler.trace(d):
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
        report(label, d, wall, steps, args.top, out)
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
