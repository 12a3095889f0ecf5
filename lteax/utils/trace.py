"""Profiling / tracing helpers (SURVEY.md §5: jax.profiler + named scopes).

Usage:
    with stage("turbo_decode"):
        ...jitted calls...          # appears as a named scope in the trace

    with profile_to("/tmp/trace"):  # TensorBoard-loadable trace
        run()
"""

from __future__ import annotations

import contextlib
import time

import jax


def stage(name: str):
    """Named scope visible in jax.profiler traces (no-op cost outside capture)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def profile_to(logdir: str):
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def wall_timer(record: dict, key: str):
    """Accumulate wall-clock into record[key] (blocks on device results only
    if the caller does)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record[key] = record.get(key, 0.0) + time.perf_counter() - t0
