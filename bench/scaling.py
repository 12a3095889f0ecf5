"""Scaling benchmark: samples/s of the sharded PRODUCTION decode (turbo
kernel + early stop + shard-local compacted retry) vs device count
(north star: >=80% efficiency 1 GPU -> N).

Each device count decodes ``--per-dev`` subframes per device on a 1 x N
mesh.  ``--xla-turbo`` benches the plain XLA-scan reference decoder
instead; ``--acquire`` the composed halo-PSS + decode pipeline.

    python bench/scaling.py [--n-rb 100] [--mcs 28] [--per-dev 64]

Prints one JSON list.  Fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-rb", type=int, default=100)
    ap.add_argument("--mcs", type=int, default=28)
    ap.add_argument("--xla-turbo", action="store_true",
                    help="bench the XLA-scan reference decoder instead")
    ap.add_argument("--acquire", action="store_true",
                    help="bench the composed halo-PSS + decode pipeline")
    ap.add_argument("--per-dev", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    from lteax.utils.device import bench_device
    device = bench_device()
    import jax
    import jax.numpy as jnp
    from bench.common import time_batches
    from lteax.shard.mesh import make_mesh, time_sharding
    from lteax.shard.pipeline import (make_sharded_decoder,
                                      make_sharded_decoder_pallas,
                                      make_sharded_acquire_decoder_pallas)
    from lteax.sim.batches import dl_batch

    n_dev_all = len(jax.devices())
    counts = [d for d in (1, 2, 4, 8) if d <= n_dev_all]
    batch = dl_batch(a.per_dev * counts[-1], n_rb=a.n_rb, mcs=a.mcs,
                     snr_db=30.0)
    cfg = batch.cfg
    results = []
    for n_dev in counts:
        mesh = make_mesh(n_chan=1, n_time=n_dev,
                         devices=jax.devices()[:n_dev])
        maker = (make_sharded_decoder if a.xla_turbo
                 else make_sharded_acquire_decoder_pallas if a.acquire
                 else make_sharded_decoder_pallas)
        dec = maker(mesh, *batch.decoder_args(), n_iter=6)
        n_sf = a.per_dev * n_dev
        xd = jax.device_put(jnp.asarray(batch.x_iq[:n_sf]),
                            time_sharding(mesh, 3))
        n_ok = int(dec(xd)[2])
        t = min(time_batches(dec, xd, a.reps))
        sps = n_sf * cfg.n_samps_subframe / t
        results.append({"n_dev": n_dev, "samples_per_s": sps,
                        "ms": t * 1e3, "n_ok": n_ok, "total_sf": n_sf,
                        "device": device})
        print(f"n_dev={n_dev}: {sps/1e6:.2f} Msps, {t*1e3:.1f} ms, "
              f"crc {n_ok}/{n_sf}", file=sys.stderr)
    base = results[0]["samples_per_s"]
    for r in results:
        r["efficiency"] = r["samples_per_s"] / (base * r["n_dev"])
    print(json.dumps(results))


if __name__ == "__main__":
    main()
