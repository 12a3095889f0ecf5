"""Multi-carrier cell scanner: N channels -> per-channel cell reports.

(reference capability: ``LTE_fdd_dl_scan/src/LTE_fdd_dl_scan_block.cc ::
work`` + ``_flowgraph.cc`` retune loop + ``_interface.cc`` ctrl reports —
SURVEY.md §3.4.  The reference retunes ONE SDR serially through a band;
here channels are a batch axis: captures at arbitrary rates are polyphase-
resampled to the native LTE rate and each runs the whole-capture batched
cell-search pipeline.  Config #5 shards this channel axis across hosts.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from fractions import Fraction

import numpy as np
import jax.numpy as jnp

from lteax.phy.config import PhyConfig
from lteax.apps.file_scan import scan, ScanResult
from lteax.kernels.polyphase import resample_poly
from lteax.io.iq import read_iq
from lteax.stack import bands
from lteax.utils.metrics import EVENTS, METRICS
from lteax.utils.trace import stage


@dataclasses.dataclass
class Channel:
    label: str                  # e.g. EARFCN or filename
    path: str
    fmt: str = "fc32"
    rate_hz: float | None = None   # capture rate; None == native


def scan_channel(ch: Channel, cfg: PhyConfig) -> ScanResult:
    x = read_iq(ch.path, ch.fmt)
    METRICS.inc("scanner.samples_in", len(x))
    if ch.rate_hz is not None and abs(ch.rate_hz - cfg.fs) > 1.0:
        frac = Fraction(int(round(cfg.fs)), int(round(ch.rate_hz))) \
            .limit_denominator(1024)
        with stage("resample"):
            x = np.asarray(resample_poly(jnp.asarray(x), frac.numerator,
                                         frac.denominator))
    with stage("cell_search"):
        return scan(x, cfg)


def prescan_channels(chans: list[Channel], cfg: PhyConfig) -> list[dict]:
    """Device-batched stage 1: PSS detection for every channel at once,
    sharded over the chan mesh axis (shard/scanner.py).  Channels are
    resampled to the native rate and trimmed to a common prefix length."""
    import jax
    from lteax.shard.mesh import make_mesh
    from lteax.shard.scanner import batched_prescan
    caps = []
    for ch in chans:
        x = read_iq(ch.path, ch.fmt)
        if ch.rate_hz is not None and abs(ch.rate_hz - cfg.fs) > 1.0:
            frac = Fraction(int(round(cfg.fs)), int(round(ch.rate_hz))) \
                .limit_denominator(1024)
            x = np.asarray(resample_poly(jnp.asarray(x), frac.numerator,
                                         frac.denominator))
        caps.append(x)
    l = min(len(c) for c in caps)
    caps = np.stack([c[:l] for c in caps])
    n_dev = len(jax.devices())
    n_chan_axis = min(len(chans), n_dev)
    mesh = make_mesh(n_chan=n_chan_axis, n_time=n_dev // n_chan_axis)
    return batched_prescan(caps, cfg, mesh)


def scan_channels(chans: list[Channel], cfg: PhyConfig,
                  checkpoint_path: str | None = None,
                  prescan: bool = False) -> list[dict]:
    """Scan every channel; returns JSON-able report dicts.

    Heavy per-channel stages (resample, PSS correlation, subframe demod,
    turbo decode) are device-batched inside ``scan``; the channel loop is
    host control-plane.  The pod-scale variant shards this loop over the
    ``chan`` mesh axis (shard/mesh.py).

    With ``checkpoint_path``, finished channels are persisted and skipped
    on restart (idempotent work units, SURVEY.md §5 failure recovery).
    """
    ckpt = None
    if checkpoint_path:
        from lteax.utils.checkpoint import ScanCheckpoint
        ckpt = ScanCheckpoint(checkpoint_path)
    pre = prescan_channels(chans, cfg) if prescan else None
    reports = []
    for ci, ch in enumerate(chans):
        if ckpt is not None and ckpt.done(ch.label):
            EVENTS.emit("scan.skip", level="debug", channel=ch.label,
                        reason="checkpointed")
            reports.append(ckpt.result(ch.label))
            continue
        if pre is not None and not pre[ci]["detected"]:
            d = {"channel": ch.label, "mib": None, "n_cell_id": -1,
                 "prescan": pre[ci]}
            EVENTS.emit("scan.dead", level="debug", channel=ch.label)
            METRICS.inc("scanner.channels_dead")
            if ckpt is not None:
                ckpt.record(ch.label, d)
            reports.append(d)
            continue
        EVENTS.emit("scan.start", level="debug", channel=ch.label)
        try:
            r = scan_channel(ch, cfg)
            d = json.loads(r.to_json())
        except Exception as e:  # pragma: no cover - robustness path
            d = {"error": f"{type(e).__name__}: {e}"}
            EVENTS.emit("scan.error", level="error", channel=ch.label,
                        **d)
            METRICS.inc("scanner.errors")
        d["channel"] = ch.label
        if ch.label.isdigit():
            try:
                d["freq_mhz"] = bands.dl_earfcn_to_freq_mhz(int(ch.label))
                d["band"] = bands.band_of_dl_earfcn(int(ch.label))
            except ValueError:
                pass
        METRICS.inc("scanner.channels_scanned")
        if d.get("n_cell_id", -1) >= 0:
            METRICS.inc("scanner.cells_found")
            EVENTS.emit("scan.cell", channel=ch.label,
                        n_cell_id=d.get("n_cell_id"),
                        sfn=(d.get("mib") or {}).get("sfn"),
                        tac=(d.get("sib1") or {}).get("tac"),
                        freq_mhz=d.get("freq_mhz"))
        if ckpt is not None:
            ckpt.record(ch.label, d)
        reports.append(d)
    return reports


def _parse_channels(specs) -> list[Channel]:
    chans = []
    for spec in specs:
        label, rest = spec.split("=", 1)
        parts = rest.split(":")
        chans.append(Channel(
            label=label, path=parts[0],
            fmt=parts[1] if len(parts) > 1 else "fc32",
            rate_hz=float(parts[2]) if len(parts) > 2 else None))
    return chans


def run_multihost_worker(a, chans, cfg) -> int:
    """One process of a config-#5 multi-process scan (SURVEY.md §7 step 8).

    ``jax.distributed`` joins the processes into one runtime; the CHANNEL
    axis is partitioned across processes (channel ci belongs to process
    ci % n).  Each process scans its partition with an idempotent
    per-worker checkpoint, then all processes meet in one psum that
    aggregates the global cells-found count over the ``host`` mesh axis —
    the DCN-collective path of the pod scanner.

    Elastic recovery model: SPMD jobs restart whole (a dead process leaves
    peers blocked at the final collective), but work units are
    checkpointed, so a relaunch re-scans only unfinished channels
    (SURVEY.md §5)."""
    import os
    import jax

    os.environ["JAX_PLATFORMS"] = "cpu"     # local-process emulation of a
    jax.config.update("jax_platforms", "cpu")   # pod host (SURVEY.md §4)
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{a.port}",
        num_processes=a.multihost, process_id=a.worker_idx)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    devs = np.asarray(jax.devices()).reshape(a.multihost, -1)
    mesh = Mesh(devs, ("host", "dev"))

    def agg(x):
        return jax.lax.psum(x, "host")

    fn = jax.jit(shard_map(agg, mesh=mesh, in_specs=(P("host"),),
                           out_specs=P()))
    from jax.experimental import multihost_utils

    def psum_scalar(v: int) -> int:
        garr = multihost_utils.host_local_array_to_global_array(
            np.asarray([v], np.int32), mesh, P("host"))
        return int(np.asarray(
            multihost_utils.global_array_to_host_local_array(
                fn(garr), mesh, P()))[0])

    # establish the collective (Gloo) context while all processes are
    # still in lock-step — per-worker scan durations can exceed its
    # connect timeout, and connections persist once made
    psum_scalar(0)

    mine = [ch for ci, ch in enumerate(chans)
            if ci % a.multihost == a.worker_idx]
    ckpt_path = (f"{a.checkpoint}.w{a.worker_idx}" if a.checkpoint else None)
    reports = scan_channels(mine, cfg, checkpoint_path=ckpt_path)
    # count DECODED cells (MIB present) — raw PSS peaks fire on noise
    total = psum_scalar(
        sum(1 for d in reports if d.get("mib") is not None))
    for d in reports:
        d["worker"] = a.worker_idx
        print(json.dumps(d), flush=True)
    print(json.dumps({"multihost_total_cells": total,
                      "worker": a.worker_idx}), flush=True)
    jax.distributed.shutdown()
    return 0


def run_multihost_coordinator(a, argv) -> int:
    """Spawn the N worker processes; a worker death means the job must be
    relaunched (peers block at the final collective) — the checkpoints make
    the relaunch cheap."""
    import subprocess
    import sys as _sys
    procs = []
    for i in range(a.multihost):
        procs.append(subprocess.Popen(
            [_sys.executable, "-m", "lteax.apps.scanner", *argv,
             "--worker-idx", str(i)]))
    rcs = [p.wait() for p in procs]
    if any(rc != 0 for rc in rcs):
        print(json.dumps({"multihost_error": f"worker rcs {rcs}; relaunch "
                          "to resume from checkpoints"}), flush=True)
        return 1
    return 0


def main(argv=None):
    import sys as _sys
    argv = list(argv) if argv is not None else _sys.argv[1:]
    p = argparse.ArgumentParser(
        description="multi-carrier LTE cell scanner over IQ captures")
    p.add_argument("captures", nargs="+",
                   help="LABEL=PATH[:FMT[:RATE_HZ]] per channel")
    p.add_argument("--n-rb", type=int, default=6)
    p.add_argument("--prescan", action="store_true",
                   help="device-batched PSS prescan; skip dead channels")
    p.add_argument("--checkpoint", default=None,
                   help="resume file (skip finished channels)")
    p.add_argument("--eventlog", default=None,
                   help="JSON-lines event log path ('-' = stdout)")
    p.add_argument("--debug-level", default="info",
                   choices=("error", "warn", "info", "debug"))
    p.add_argument("--multihost", type=int, default=0, metavar="N",
                   help="run as an N-process jax.distributed scan "
                        "(channel axis across processes)")
    p.add_argument("--port", type=int, default=36911,
                   help="multihost coordinator port")
    p.add_argument("--worker-idx", type=int, default=None,
                   help=argparse.SUPPRESS)   # internal: worker process id
    a = p.parse_args(argv)
    if a.multihost and a.worker_idx is None:
        raise SystemExit(run_multihost_coordinator(a, argv))
    if a.multihost:
        cfg = PhyConfig(n_rb_dl=a.n_rb)
        chans = _parse_channels(a.captures)
        raise SystemExit(run_multihost_worker(a, chans, cfg))
    if a.eventlog:
        EVENTS.open(a.eventlog)
        EVENTS.set_level(a.debug_level)
    cfg = PhyConfig(n_rb_dl=a.n_rb)
    chans = _parse_channels(a.captures)
    for rep in scan_channels(chans, cfg, checkpoint_path=a.checkpoint,
                             prescan=a.prescan):
        print(json.dumps(rep))
    if a.eventlog:
        METRICS.dump()


if __name__ == "__main__":
    main()
