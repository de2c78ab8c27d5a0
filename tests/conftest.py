"""Test harness: run everything on the CPU backend with 8 virtual devices.

Mirrors the reference's test strategy (SURVEY.md §4): per-op unit tests
against CPU references — numpy, or the float32 ``*_ref`` implementation of
each op at "highest" matmul precision. The 8-device virtual mesh exercises
the sharding path without accelerators
(``xla_force_host_platform_device_count`` pattern, SNIPPETS.md [2]).
"""

import os

# LLM_ENGINE_TESTS_ON_GPU=1 runs the card-only tests (marker ``gpu``) on
# the GPU; otherwise everything runs on the CPU with 8 virtual devices.
ON_GPU = os.environ.get("LLM_ENGINE_TESTS_ON_GPU") == "1"

# must run before the first JAX backend initialization
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng(request):
    # function-scoped + seeded from the test id (stable crc32, not str
    # hash — that is salted per process): every test gets the SAME draws
    # regardless of selection or order (a session-scoped stream made
    # marginal-tolerance tests flake depending on which tests ran before)
    import zlib
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


@pytest.fixture(scope="session", autouse=True)
def _verify_cpu():
    if not ON_GPU:
        assert jax.default_backend() == "cpu", (
            f"tests must run on CPU, got {jax.default_backend()}")
        assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"
    yield


@pytest.fixture()
def gpu():
    """Tests marked ``gpu`` take this fixture: they run only on the card
    (LLM_ENGINE_TESTS_ON_GPU=1) and skip elsewhere."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (LLM_ENGINE_TESTS_ON_GPU=1)")
    return jax.devices()[0]
