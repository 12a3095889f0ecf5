"""The accelerator a measurement runs on.

Every speed number names its device: JAX's platform, ``device_kind`` and
device count, plus the card's name and power limit as ``nvidia-smi`` gives
them (a card set below its maximum power runs slower under load).
"""

from __future__ import annotations

import subprocess


def nvidia_smi_line() -> str:
    """``name, power.limit`` of the cards, one line each, from a child
    process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu() -> dict:
    """The device JAX runs on, as a dict; raises SystemExit unless it is a
    GPU (a measurement path never falls back to the CPU)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {devs[0].platform!r}; "
                         "this measures the GPU only")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def bench_device() -> dict:
    """Start-up of a benchmark: the GPU it runs on (SystemExit without
    one), with the ``nvidia-smi`` line, and the persistent compile cache
    turned on."""
    from lteax.utils.compile_cache import enable_compile_cache
    device = require_gpu()
    device["nvidia_smi"] = nvidia_smi_line()
    enable_compile_cache()
    return device
