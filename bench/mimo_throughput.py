"""2x2 TM3 (dual-codeword spatial multiplexing) decode throughput, 20 MHz.

Full receive chain per subframe: OFDM demod on 2 RX antennas -> CRS
channel estimation per (rx, port) -> TM3 effective channel -> per-RE 2x2
MMSE demix -> per-layer 64QAM max-log demap -> per-codeword descramble /
de-match -> one turbo batch over BOTH codewords -> CRC.

Two TBS-75376 codewords per subframe = 150.752 Mbit per TTI-second — a
capability beyond the reference's single-codeword ceiling.

    python bench/mimo_throughput.py [--batch 256] [--reps 6] [--tm 4]

Prints one JSON line.  Fails without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CMATS = {
    # well-conditioned fixed 2x2 channel
    "bench": [[1.0 + 0.1j, 0.3 - 0.25j], [0.2 + 0.3j, -0.95 + 0.1j]],
    # correlated, asymmetric column powers (the SIC regime): linear MMSE
    # pays the correlation penalty on both layers, SIC only on the first
    "corr": [[1.0, 0.334], [0.6, 0.608]],
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--mcs", type=int, default=28)
    ap.add_argument("--tm", type=int, default=3, choices=(3, 4))
    ap.add_argument("--cb-index", type=int, default=0)
    ap.add_argument("--snr-db", type=float, default=25.0)
    ap.add_argument("--cmat", default="bench",
                    help="'bench', 'corr', or 8 comma-separated re,im pairs "
                         "row-major")
    a = ap.parse_args()
    from lteax.utils.device import bench_device
    device = bench_device()
    import jax
    import jax.numpy as jnp
    from bench.common import time_batches
    from lteax.shard.pipeline import make_mimo_batch_decoder
    from lteax.sim.batches import mimo_batch

    if a.cmat in CMATS:
        cmat = np.array(CMATS[a.cmat], np.complex64)
    else:
        v = [float(t) for t in a.cmat.split(",")]
        cmat = (np.array(v[0::2]) + 1j * np.array(v[1::2])
                ).reshape(2, 2).astype(np.complex64)
    b = a.batch
    mb = mimo_batch(b, mcs=a.mcs, snr_db=a.snr_db, tm=a.tm,
                    cb_index=a.cb_index, cmat=cmat)
    f = make_mimo_batch_decoder(*mb.decoder_args(), n_iter=a.iters, tm=a.tm,
                                cb_index=a.cb_index)
    xd = jax.device_put(jnp.asarray(mb.x_iq))
    bits, ok = f(xd)[:2]
    n_ok = int(np.sum(np.asarray(ok)))
    want = mb.tb_bits.transpose(1, 0, 2).reshape(2 * b, -1)
    exact = bool(np.array_equal(np.asarray(bits), want))
    t, t_sus = time_batches(f, xd, a.reps)
    print(f"crc ok {n_ok}/{2 * b}, exact {exact}; per-batch {t*1e3:.2f} ms, "
          f"sustained {t_sus*1e3:.2f} ms", file=sys.stderr)
    mbps = 2 * b * mb.geom.tbs / min(t, t_sus) / 1e6
    print(json.dumps({
        "metric": f"decoded 2x2 TM{a.tm} dual-codeword DL-SCH, 20 MHz MCS"
                  f"{a.mcs}",
        "value": round(mbps, 2), "unit": "Mbit/s/chip",
        "crc_ok": n_ok, "batch": b, "device": device}))


if __name__ == "__main__":
    main()
