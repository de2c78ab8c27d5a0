"""Published peaks of the cards the benchmarks divide by, keyed by the
``device_kind`` JAX reports. A device that is not in the table is an error,
never a default.

Source: NVIDIA H100 Tensor Core GPU data sheet (dense rates, without
sparsity): SXM5 80 GB — 989 TFLOP/s bf16, 3.35 TB/s HBM3, 700 W; PCIe 80 GB
— 756 TFLOP/s bf16, 2.0 TB/s HBM2e, 350 W. The rates assume the full power
limit; report the card's ``power.limit`` beside any share of them.
"""

from __future__ import annotations

import subprocess

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
    "NVIDIA H100 PCIe": {"bf16_flops": 756e12, "hbm_bytes_per_s": 2.0e12},
}


def peaks(device) -> dict:
    """The published peaks of ``device`` (a jax.Device)."""
    kind = device.device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; add "
                       f"them to benchmarks/device_peaks.py with a source")
    return PEAKS[kind]


def card_identity(device) -> dict:
    """platform, device_kind and the nvidia-smi name/power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return {"platform": device.platform, "kind": device.device_kind,
            "nvidia_smi": smi[device.id] if device.id < len(smi) else smi}


def require_gpu():
    """The first JAX device; exits when it is not a GPU (a measurement
    never falls back to the CPU)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU found (JAX platform {dev.platform!r}); "
                         "this benchmark measures the card only")
    return dev
