"""Cell-search front-end throughput: PSS correlation Msps per chip.

The reference scanner's hot loop is the PSS matched filter over raw samples
(SURVEY §3.1/§3.4 — ``liblte_phy_find_pss_and_fine_timing`` runs serially
per EARFCN).  Here all carriers are one batched jitted call; this bench
measures how many complex Msps of raw 20 MHz capture one GPU can sweep for
PSS (3 roots), i.e. the band-scan rate ceiling.

    python bench/scan_throughput.py [--carriers 16] [--len-sf 20]

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
    ap.add_argument("--carriers", type=int, default=16)
    ap.add_argument("--len-sf", type=int, default=20,
                    help="capture length per carrier, subframes")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--depth", type=int, default=2,
                    help="sweeps in flight (sustained mode)")
    a = ap.parse_args()
    from lteax.utils.device import bench_device
    device = bench_device()
    import jax
    import jax.numpy as jnp
    from bench.common import time_batches
    from lteax.phy.config import PhyConfig
    from lteax.phy.sync import pss_correlate
    from lteax.phy.seq import pss_sequence
    from lteax.phy.ofdm import subframe_to_samples

    cfg = PhyConfig(n_rb_dl=100)
    L = a.len_sf * cfg.n_samps_subframe
    rng = np.random.default_rng(0)
    # synthesize: noise + a PSS-bearing subframe per carrier
    x = (rng.standard_normal((a.carriers, L))
         + 1j * rng.standard_normal((a.carriers, L))).astype(np.complex64)
    x *= 0.1
    grid = np.zeros((cfg.n_sym_subframe, cfg.n_sc), np.complex64)
    k0 = cfg.n_sc // 2 - 31
    grid[6, k0:k0 + 62] = pss_sequence(1)
    sf = np.asarray(subframe_to_samples(jnp.asarray(grid[None]), cfg))[0]
    for c in range(a.carriers):
        off = 3000 + 977 * c
        x[c, off:off + len(sf)] += sf
    x_iq = np.stack([x.real, x.imag], -1).astype(np.float32)
    xd = jax.device_put(jnp.asarray(x_iq))

    def detect(xi):
        s = (xi[..., 0] + 1j * xi[..., 1]).astype(jnp.complex64)
        p = pss_correlate(s, cfg)                     # (C, 3, L)
        root_max = jnp.max(p, axis=-1)
        nid2 = jnp.argmax(root_max, axis=-1)
        pr = jnp.take_along_axis(p, nid2[:, None, None], axis=1)[:, 0, :]
        peak = jnp.max(pr, axis=-1)
        idx = jnp.argmax(pr, axis=-1)
        ratio = peak / jnp.maximum(jnp.mean(p, axis=(-2, -1)), 1e-20)
        return nid2, idx, ratio

    f = jax.jit(detect)
    nid2_h = np.asarray(f(xd)[0])
    assert (nid2_h == 1).all(), "PSS root misdetected"
    t, t_sus = time_batches(f, xd, a.reps, a.depth)
    print(f"per-sweep median {t*1e3:.2f} ms, sustained ({a.depth} in "
          f"flight) {t_sus*1e3:.2f} ms for {a.carriers}x{a.len_sf} sf",
          file=sys.stderr)
    msps = a.carriers * L / min(t, t_sus) / 1e6
    print(json.dumps({
        "metric": "PSS cell-search sweep rate, 20 MHz carriers (3 roots)",
        "value": round(msps, 1), "unit": "Msps/chip",
        "vs_line_rate": round(msps / 30.72, 1), "device": device}))


if __name__ == "__main__":
    main()
