"""UL-SCH (PUSCH) decode throughput on one GPU.

Full SC-FDMA receive chain: DM-RS LS chest + MMSE eq + IDFT de-precoding +
max-log demap + channel de-interleave + descramble + de-match + turbo +
CRC.  20 MHz (100 PRB), TBS 75376, 64QAM.

    python bench/ul_throughput.py [--batch 640] [--reps 6]

Prints one JSON line.  Fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=640)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--static-nv", action="store_true",
                    help="pin the true noise_var instead of the per-subframe"
                         " DM-RS-residual estimate")
    ap.add_argument("--snr-db", type=float, default=25.0)
    a = ap.parse_args()
    from lteax.utils.device import bench_device
    device = bench_device()
    import jax
    import jax.numpy as jnp
    from bench.common import time_batches
    from lteax.shard.pipeline import make_pusch_batch_decoder
    from lteax.sim.batches import ul_batch

    b = a.batch
    alloc, rnti, sf, cid, x_iq, tb = ul_batch(b, snr_db=a.snr_db)
    nv = 10 ** (-a.snr_db / 10.0)
    f = make_pusch_batch_decoder(alloc, rnti, sf, cid, n_iter=a.iters,
                                 noise_var=nv if a.static_nv else None)
    xd = jax.device_put(jnp.asarray(x_iq.astype(jnp.bfloat16)))
    bits, ok = f(xd)[:2]
    n_ok = int(np.sum(np.asarray(ok)))
    exact = bool(np.array_equal(np.asarray(bits), tb))
    t, t_sus = time_batches(f, xd, a.reps)
    print(f"crc ok {n_ok}/{b}, exact {exact}; per-batch {t*1e3:.2f} ms, "
          f"sustained {t_sus*1e3:.2f} ms", file=sys.stderr)
    mbps = b * alloc.mcs_tbs / min(t, t_sus) / 1e6
    print(json.dumps({"metric": "decoded UL-SCH throughput, 20 MHz 64QAM "
                                "TBS 75376",
                      "value": round(mbps, 2), "unit": "Mbit/s/chip",
                      "crc_ok": n_ok, "batch": b, "device": device}))


if __name__ == "__main__":
    main()
