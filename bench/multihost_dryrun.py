"""Multi-host (multi-process) dry run: jax.distributed over N local
processes, channel axis across processes (config #5 shape).

(SURVEY.md §4: "jax.distributed multi-process tests spawned locally to
exercise the cross-device code paths deterministically".)

Each process owns a set of scanner channels (channel axis across "hosts"),
computes local PSS-detection scores on its own devices, and the cell-count
metric is psum'd across processes.  Run:

    python bench/multihost_dryrun.py            # spawns N=2 workers
    python bench/multihost_dryrun.py --worker I # internal
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def worker(idx: int, n_proc: int, port: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
        " --xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=n_proc, process_id=idx)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    from lteax.phy.config import PhyConfig
    from lteax.apps.file_gen import GenConfig, generate
    from lteax.phy.sync import pss_correlate

    cfg = PhyConfig(n_rb_dl=6)
    # this process's channels: one live cell (id varies by process), one dead
    rng = np.random.default_rng(idx)
    live = generate(GenConfig(n_rb_dl=6, n_cell_id=100 + idx, n_frames=1))
    dead = 0.01 * (rng.standard_normal(len(live))
                   + 1j * rng.standard_normal(len(live))).astype(np.complex64)
    chans = np.stack([live, dead])

    devs = np.asarray(jax.devices()).reshape(n_proc, -1)
    mesh = Mesh(devs, ("host", "dev"))

    def local_scan(x):
        p = pss_correlate(x[0], cfg)
        peak = jnp.max(p)
        mean = jnp.mean(p)
        detected = (peak > 30.0 * mean).astype(jnp.int32)
        total = jax.lax.psum(detected, "host")
        return total[None]

    fn = jax.jit(shard_map(local_scan, mesh=mesh,
                           in_specs=(P("host", None, None),),
                           out_specs=P("host")))
    # global array: (n_proc, 2, L) sharded over host axis — each process
    # provides its local block
    from jax.experimental import multihost_utils
    garr = multihost_utils.host_local_array_to_global_array(
        chans[None], mesh, P("host", None, None))
    out = fn(garr)
    local = multihost_utils.global_array_to_host_local_array(
        out, mesh, P("host"))
    n_detected = int(np.asarray(local)[0])
    print(f"[proc {idx}] global detected cells: {n_detected}", flush=True)
    assert n_detected == n_proc, (n_detected, n_proc)
    jax.distributed.shutdown()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=-1)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--port", type=int, default=35421)
    a = ap.parse_args()
    if a.worker >= 0:
        worker(a.worker, a.nproc, a.port)
        return
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(i), "--nproc",
         str(a.nproc), "--port", str(a.port)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for i in range(a.nproc)]
    rcs = [p.wait(timeout=300) for p in procs]
    assert all(rc == 0 for rc in rcs), rcs
    print("multihost dryrun OK")


if __name__ == "__main__":
    main()
