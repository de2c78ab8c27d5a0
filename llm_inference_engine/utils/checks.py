"""Numerical-safety instrumentation (the sanitizer tier).

The reference has no sanitizers; its correctness discipline is a full
device sync + error check after every kernel launch
(src/utils/macro.h:60-71) plus shape asserts (macro.h:95, e.g.
linear.cu:62-63). The equivalents here:

- shape asserts stay eager Python (they run at trace time, free);
- ``nan_guard`` wraps a jitted step with ``jax.experimental.checkify``
  float checks, so NaN/Inf produced anywhere inside the compiled program
  raises host-side with the failing primitive's location — the runtime
  analogue of DeviceSyncAndCheckCudaError, opt-in because it inserts
  device-wide checks;
- ``assert_finite`` spot-checks a single named tensor inside jit.

Both work under jit on GPU and CPU; guard overhead is zero when not used
(normal paths never import checkify).
"""

from __future__ import annotations

import functools

import jax
from jax.experimental import checkify

__all__ = ["nan_guard", "assert_finite"]


def nan_guard(fn, *, div: bool = True):
    """Wrap ``fn`` so every float op inside is checked for NaN/Inf.

    Returns a callable with the same signature; on bad values it raises
    ``jax.experimental.checkify.JaxRuntimeError`` naming the source line.
    The wrapped function re-jits independently of ``fn`` (checkify
    rewrites the jaxpr), so use it for debugging runs, not serving.
    """
    errs = checkify.float_checks if div else checkify.nan_checks
    checked = checkify.checkify(fn, errors=errs)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        err, out = checked(*args, **kwargs)
        err.throw()
        return out

    return run


def assert_finite(name: str, x: jax.Array) -> None:
    """Inside-jit spot check: debug-print a warning iff ``x`` has any
    non-finite entries (does not abort — usable in serving paths)."""
    import jax.numpy as jnp
    from jax import lax

    bad = jnp.size(x) - jnp.sum(jnp.isfinite(x).astype(jnp.int32))
    lax.cond(
        bad > 0,
        lambda b: jax.debug.print(
            "[checks] " + name + ": {b} non-finite of "
            + str(int(jnp.size(x))), b=b),
        lambda b: None,
        bad)
