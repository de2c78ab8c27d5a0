"""Intermediate-tensor dump / compare utilities.

Capability parity with the reference's debug tooling:
- ``saveTensor`` binary dumps of layer intermediates under SAVE_DATA
  (reference: src/utils/debug_utils.h:18-119, used at
  context_attention.cpp:193-304) -> ``TensorDumper`` (works inside jit via
  jax.debug.callback, or eagerly);
- the offline diff the reference only mentions (debug_utils.h:15 refers to
  a test_data_compare.cu that does not exist in its tree) -> ``compare_dumps``
  actually implemented;
- ``print_data`` device peeks under PRINT_DATA
  (reference: src/utils/cuda_debug_utils.cuh:7-25) -> ``peek``.

Dumps are .npy (self-describing) instead of raw bytes.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

__all__ = ["TensorDumper", "DebugTap", "tap", "set_dump_dir",
           "compare_dumps", "peek"]


class TensorDumper:
    """Dump named intermediates; enabled by constructing with a directory
    (or the LLM_ENGINE_SAVE_DATA env var), a no-op otherwise — mirroring the
    reference's compile-time SAVE_DATA gate as a runtime switch."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or os.environ.get("LLM_ENGINE_SAVE_DATA")
        self._counter = 0
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return bool(self.directory)

    def _path(self, name: str) -> str:
        self._counter += 1
        return os.path.join(self.directory, f"{self._counter:04d}_{name}.npy")

    def dump(self, name: str, value) -> None:
        """Eager dump (outside jit)."""
        if not self.enabled:
            return
        np.save(self._path(name), np.asarray(value))

    def dump_in_jit(self, name: str, value) -> None:
        """Dump from inside a jitted function (host callback; ordered so
        files appear in execution order)."""
        if not self.enabled:
            return
        path = self._path(name)
        jax.debug.callback(lambda x: np.save(path, np.asarray(x)), value,
                           ordered=True)


class DebugTap:
    """The forward pass's dump hook (models/llama.py calls it at every
    kernel boundary — the same points the reference dumps under SAVE_DATA,
    context_attention.cpp:193-304). Disabled (the default) it returns at
    TRACE time, adding zero ops to the compiled program. Enabled — via the
    LLM_ENGINE_SAVE_DATA env var or :func:`set_dump_dir` — it inserts ordered
    host callbacks that write one .npy per intermediate, with per-layer
    values gated to the first ``max_layers`` layers on the HOST side (the
    layer index is a traced scan value; the reference likewise dumped only
    layers 0-2, debug_utils.h:49)."""

    def __init__(self, directory: Optional[str] = None,
                 max_layers: int = 3):
        self.dumper = TensorDumper(directory)
        self.max_layers = int(os.environ.get("LLM_ENGINE_SAVE_LAYERS",
                                             max_layers))

    @property
    def enabled(self) -> bool:
        return self.dumper.enabled

    def __call__(self, name: str, value, layer=None) -> None:
        if not self.enabled:
            return
        if layer is None:
            self.dumper.dump_in_jit(name, value)
            return
        d = self.dumper
        cap = self.max_layers

        def cb(l, x):
            li = int(l)
            if li < cap:
                np.save(d._path(f"L{li}_{name}"), np.asarray(x))

        jax.debug.callback(cb, layer, value, ordered=True)


#: process-wide tap consulted by the model forward; reconfigure with
#: set_dump_dir (tests) or the LLM_ENGINE_SAVE_DATA env var (CLI).
tap = DebugTap()


def set_dump_dir(directory: Optional[str], max_layers: int = 3) -> DebugTap:
    """(Re)point the global tap at ``directory`` (None disables). Returns
    the new tap. Callers must re-trace (new engine / cleared jit cache)
    for the change to take effect inside already-compiled programs."""
    global tap
    tap = DebugTap(directory, max_layers)
    return tap


def compare_dumps(dir_a: str, dir_b: str, atol: float = 1e-3,
                  rtol: float = 1e-3) -> list[str]:
    """Diff two dump directories by matching file suffix (name after the
    counter). Returns list of mismatching names (empty = all close)."""

    def index(d):
        out = {}
        for f in sorted(os.listdir(d)):
            if f.endswith(".npy"):
                out[f.split("_", 1)[1]] = os.path.join(d, f)
        return out

    a, b = index(dir_a), index(dir_b)
    bad = []
    for name in sorted(set(a) & set(b)):
        x, y = np.load(a[name]), np.load(b[name])
        if x.shape != y.shape or not np.allclose(
                x.astype(np.float64), y.astype(np.float64), atol=atol,
                rtol=rtol):
            bad.append(name)
    bad += [f"missing:{n}" for n in sorted(set(a) ^ set(b))]
    return bad


def peek(name: str, value, num: int = 8) -> None:
    """Print the first elements of a device array from inside jit
    (reference print_data<<<1,1>>> equivalent)."""
    jax.debug.print(name + ": {}", value.ravel()[:num])
