"""HARQ IR combining overhead vs single-rv decode.

Measures the PRODUCTION HARQ decoder (``make_batch_harq_decoder_pallas``:
two per-transmission fronts + d-domain soft-combine + one turbo batch)
against the single-rv decoder at the SAME 20 MHz / MCS 28 geometry and
batch.  The interesting number is the combining OVERHEAD: the HARQ front
runs n_tx fronts and is pinned to the d-domain boundary (the planar
statics can't ride a SUM of fronts), so the expected cost is ~n_tx times
the front stage plus the de-match materialization, with the turbo stage
unchanged.

    python bench/harq_throughput.py [--batch 384] [--snr-db 25]

Prints one JSON line: combined Mbit/s, single-rv Mbit/s, overhead ratio.
Fails without a GPU.
(reference capability: ``liblte/src/liblte_phy.cc :: rate_unmatch_turbo``
circular-buffer soft-combine.)
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
    ap.add_argument("--batch", type=int, default=384)
    ap.add_argument("--snr-db", type=float, default=25.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--depth", type=int, default=2)
    a = ap.parse_args()
    from lteax.utils.device import bench_device
    device = bench_device()
    import jax
    import jax.numpy as jnp
    from bench.common import time_batches
    from lteax.shard.pipeline import (make_batch_decoder_pallas,
                                      make_batch_harq_decoder_pallas)
    from lteax.sim.batches import dl_batch

    b = a.batch
    hb = dl_batch(b, snr_db=a.snr_db, n_unique=32, sfs_rvs=((1, 0), (2, 2)))
    xd = jax.device_put(jnp.asarray(hb.x_iq.astype(jnp.bfloat16)))
    dec_h = make_batch_harq_decoder_pallas(*hb.decoder_args(), n_iter=6)
    dec_1 = make_batch_decoder_pallas(hb.cfg, hb.cid, hb.cfi, hb.prbs,
                                      hb.sf[0], hb.rnti, hb.geom[0],
                                      hb.scheme, n_iter=6)
    ok_h = int(np.sum(np.asarray(dec_h(xd)[1])))
    ok_1 = int(np.sum(np.asarray(dec_1(xd[0])[1])))
    t_h = min(time_batches(dec_h, xd, a.reps, a.depth))
    t_1 = min(time_batches(dec_1, xd[0], a.reps, a.depth))
    tbs = hb.geom[0].tbs
    mbps_h = tbs * b / t_h / 1e6
    mbps_1 = tbs * b / t_1 / 1e6
    print(f"single-rv: {t_1*1e3:.2f} ms/batch ({mbps_1:.1f} Mbit/s, "
          f"crc {ok_1}/{b}); HARQ rv0+rv2: {t_h*1e3:.2f} ms/batch "
          f"({mbps_h:.1f} Mbit/s, crc {ok_h}/{b})", file=sys.stderr)
    print(json.dumps({
        "metric": "HARQ IR (rv0+rv2) combining overhead, 20 MHz MCS28",
        "value": round(mbps_h, 2), "unit": "Mbit/s/chip",
        "single_rv_mbps": round(mbps_1, 2),
        "overhead_ratio": round(t_h / t_1, 3),
        "crc_ok": ok_h, "batch": b, "device": device}))


if __name__ == "__main__":
    main()
