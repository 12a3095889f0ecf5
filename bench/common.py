"""Timing shared by the benches: every call ends in block_until_ready."""

from __future__ import annotations

import time

import numpy as np


def time_batches(f, arg, reps: int, depth: int = 2) -> tuple[float, float]:
    """(median seconds per call, seconds per call with ``depth`` calls in
    flight) — the second is how the streaming apps drive the device: host
    dispatch of the next batch overlaps the current one."""
    import jax
    jax.block_until_ready(f(arg))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(arg))
        ts.append(time.perf_counter() - t0)
    inflight = []
    t0 = time.perf_counter()
    for _ in range(reps):
        inflight.append(f(arg))
        if len(inflight) >= depth:
            jax.block_until_ready(inflight.pop(0))
    jax.block_until_ready(inflight)
    return float(np.median(ts)), (time.perf_counter() - t0) / reps
