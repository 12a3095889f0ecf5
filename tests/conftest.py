"""Test configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual devices,
so the multi-device sharding paths (mesh/halo/ppermute) are exercised
without accelerators (SURVEY.md §4).  Tests marked ``gpu`` need an NVIDIA
GPU and skip elsewhere; run them on the card with ``pytest -m gpu``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU (decided per test
    at run time, never while the module is collected)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
