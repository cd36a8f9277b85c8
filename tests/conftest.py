"""Test configuration: run on a virtual 8-device CPU mesh with float64 on.

Must set env vars before jax initializes its backends.  Tests that need a
GPU carry the `gpu` marker and take the `gpu` fixture, which skips them
when JAX's default device is not a GPU (chip_smoke.py runs them on the
card)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The GPU device; skips the test when JAX's default device is not a
    GPU.  Decided here, at run time, never while modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform!r}")
    return dev
