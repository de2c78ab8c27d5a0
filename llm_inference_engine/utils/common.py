"""Small shared helpers (replaces reference src/utils/macro.h error macros and
grid math)."""

from __future__ import annotations

import jax


def cdiv(a: int, b: int) -> int:
    """Ceiling division (reference used CUDA grid rounding, e.g.
    repeat_kv.cu grid computation)."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cpu_devices(n: int | None = None):
    """The host CPU devices (used by tests/dryrun to build virtual meshes
    regardless of which accelerator backend is also registered)."""
    devs = jax.devices("cpu")
    if n is not None:
        if len(devs) < n:
            raise RuntimeError(
                f"need {n} CPU devices, have {len(devs)}; set "
                f"XLA_FLAGS=--xla_force_host_platform_device_count={n} before "
                "importing jax"
            )
        devs = devs[:n]
    return devs
