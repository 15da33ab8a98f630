import os

import pytest

# Tests run on the CPU, on a virtual 8-device mesh, so the sharding paths
# are exercised without accelerators.  Set JAX_PLATFORMS=cuda,cpu to run
# the `gpu`-marked tests on a card.  The config update covers a jax that
# was imported (and its platform chosen) before this conftest ran.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests when JAX's default device is not a GPU
    (decided per test, at run time, never at collection)."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu "
                        "python -m pytest -m gpu tests/ on the card)")
