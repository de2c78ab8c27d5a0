"""Shared example setup.

- repo root on sys.path so examples run from anywhere;
- references compare at fp32: force `highest` matmul precision (an f32
  dot may otherwise run with reduced-precision inputs, e.g. TF32 on the
  GPU, which would swamp the tolerances).

Examples that want the CPU use jax.config.update("jax_platforms", "cpu")
*before* backend init.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_default_matmul_precision", "highest")


def report(name: str, ok: bool, detail: str = "") -> None:
    status = "OK" if ok else "FAIL"
    print(f"[{status}] {name}" + (f" — {detail}" if detail else ""))
    if not ok:
        raise SystemExit(1)
