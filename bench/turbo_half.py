"""Time the turbo half-iteration kernel's launch shapes against the plain
scan at DL width on one GPU.

A config is ``BLOCKxWARPS`` (chains per program x warps).  Every config
is checked against the plain version and timed in turns with it; medians
in ms per half-iteration.

    python bench/turbo_half.py --c 29952 --mdtype bf16 256x4 128x4 64x2

Prints one JSON line per config.  Fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def parse(cfg: str):
    blk, warps = cfg.split("x")
    return int(blk), int(warps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("configs", nargs="+")
    ap.add_argument("--c", type=int, default=29952,
                    help="codeblocks (2304 subframes x 13 at bench.py's B)")
    ap.add_argument("--k", type=int, default=5824)
    ap.add_argument("--mdtype", default="bf16")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    from lteax.utils.device import bench_device
    device = bench_device()
    import jax
    from lteax.kernels.turbo_mlm import half_iteration, _pin_blane
    win, acq, n = 128, 16, a.k + 3
    n_w = -(-n // win)
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    args = (4.0 * jax.random.normal(ks[0], (win, n_w, a.c)),
            4.0 * jax.random.normal(ks[1], (win, n_w, a.c)),
            *_pin_blane(jax.random.normal(ks[2], (n_w, 8, a.c)),
                        jax.random.normal(ks[3], (n_w, 8, a.c))))
    fns = {"plain": jax.jit(partial(half_iteration, win=win, acq=acq, n=n,
                                    mdtype=a.mdtype, impl="plain"))}
    for cfg in a.configs:
        blk, warps = parse(cfg)
        fns[cfg] = jax.jit(partial(half_iteration, win=win, acq=acq, n=n,
                                   mdtype=a.mdtype, impl="kernel", block=blk,
                                   num_warps=warps))
    ref = [np.asarray(x, np.float32) for x in jax.block_until_ready(
        fns["plain"](*args))]
    for cfg in a.configs:
        got = [np.asarray(x, np.float32) for x in fns[cfg](*args)]
        same = all(np.array_equal(x, y) for x, y in zip(ref, got))
        print(f"{cfg}: bit-identical to plain {same}", file=sys.stderr)
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(a.rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            for _ in range(a.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fns[k](*args))
                times[k].append(time.perf_counter() - t0)
    for k in order:
        print(json.dumps({"config": k, "c": a.c, "mdtype": a.mdtype,
                          "ms": float(np.median(times[k]) * 1e3),
                          "min_ms": float(np.min(times[k]) * 1e3),
                          "device": device}))


if __name__ == "__main__":
    main()
