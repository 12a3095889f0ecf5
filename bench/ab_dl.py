"""Same-process A/B of DL production decoder variants on one GPU.

Each variant is a set of DecoderTuning overrides (``key=value[,key=value]``);
all decode the same 20 MHz MCS 28 batch.  After a compile-and-check call
each, the variants are timed in turns (a b b a ...) and each one's median
ms/batch and Mbit/s printed, beside the card's name and power limit.

    python bench/ab_dl.py turbo_impl=plain turbo_impl=kernel [--batch 2304]
    python bench/ab_dl.py mdtype=bf16 mdtype=f32 --stages

Prints one JSON line per variant.  Fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import fields, replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def parse_variant(spec: str, base):
    """``key=value,key=value`` -> DecoderTuning with those fields set."""
    types = {f.name: f.type for f in fields(base)}
    ov = {}
    for item in filter(None, spec.split(",")):
        k, v = item.split("=", 1)
        cur = getattr(base, k)
        if isinstance(cur, bool):
            ov[k] = v.lower() in ("1", "true")
        elif isinstance(cur, (int, float)) and cur is not None:
            ov[k] = type(cur)(v)
        else:
            assert k in types, k
            ov[k] = v
    return replace(base, **ov)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--batch", type=int, default=2304)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--snr-db", type=float, default=25.0)
    ap.add_argument("--stages", action="store_true",
                    help="also time each variant's front and turbo stage")
    a = ap.parse_args()

    from lteax.utils.device import bench_device
    device = bench_device()
    import jax
    import jax.numpy as jnp
    from lteax.phy.tuning import DecoderTuning
    from lteax.shard.pipeline import make_batch_decoder_pallas
    from lteax.sim.batches import dl_batch

    batch = dl_batch(a.batch, snr_db=a.snr_db)
    x = jax.device_put(jnp.asarray(batch.x_iq.astype(jnp.bfloat16)))
    base = DecoderTuning.from_env()
    decs = {}
    for spec in a.variants:
        t = parse_variant(spec, base)
        dec = make_batch_decoder_pallas(*batch.decoder_args(), tuning=t)
        t0 = time.perf_counter()
        bits, ok = jax.block_until_ready(dec(x))
        n_ok = int(np.sum(np.asarray(ok)))
        exact = bool(np.array_equal(np.asarray(bits), batch.tb_bits))
        print(f"{spec}: compile+first {time.perf_counter() - t0:.1f} s, "
              f"crc {n_ok}/{a.batch}, exact {exact}", file=sys.stderr)
        decs[spec] = dec
    times = {s: [] for s in decs}
    order = list(decs)
    for r in range(a.rounds):
        for s in (order if r % 2 == 0 else order[::-1]):
            for _ in range(a.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(decs[s](x))
                times[s].append(time.perf_counter() - t0)
    stage_ms = {}
    if a.stages:
        for s in order:
            mid = jax.block_until_ready(decs[s].stage_front(x))
            for name, f, arg in (("front", decs[s].stage_front, x),
                                 ("turbo", decs[s].stage_turbo, mid)):
                ts = []
                for _ in range(a.rounds * a.reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(f(arg))
                    ts.append(time.perf_counter() - t0)
                stage_ms.setdefault(s, {})[name] = float(np.median(ts) * 1e3)
    for s in order:
        t = float(np.median(times[s]))
        print(json.dumps({
            "variant": s, "batch": a.batch, "ms_per_batch": t * 1e3,
            "mbit_per_s": a.batch * batch.geom.tbs / t / 1e6,
            "spread_ms": [float(np.min(times[s]) * 1e3),
                          float(np.max(times[s]) * 1e3)],
            "stage_ms": stage_ms.get(s), "device": device}))


if __name__ == "__main__":
    main()
