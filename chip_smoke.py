#!/usr/bin/env python3
"""Start-up proof on one NVIDIA GPU: the 20 MHz receive chain end to end.

    python chip_smoke.py            # one card, phases 1-5
    python chip_smoke.py --mesh 4   # four cards: sharded DL decode and the
                                    # ppermute halo correlator only

Phases (one process; any failed check raises and exits non-zero):
  1. device: JAX must run on a GPU; prints the card's name and power limit.
  2. turbo half-iteration at DL width (K=5824, C=3328 codeblocks): the
     Pallas kernel against the plain scan, f32 and bf16 — largest LLR
     difference, hard bits, median device time, compiled memory.
  3. DL production decoder at B=256 (100 PRB, MCS 28, 25 dB): every CRC,
     bits equal to the transmitted bits and to the plain XLA decoder;
     compile time and peak device memory.
  4. UL, 2x2 MIMO and HARQ (rv0+rv2) production decoders at B=64.
  5. cell search: file_gen -> file_scan at 1.4 MHz (MIB/SIB1 must match)
     and a 16-carrier PSS detect.

The last stdout line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
from functools import partial

import numpy as np

N_ITER = 6


def log(*args):
    print(*args, flush=True)


def check(cond, what: str):
    if not cond:
        raise AssertionError(f"FAILED: {what}")
    log(f"  ok: {what}")


def _median_times(fns: dict, args, reps: int) -> dict:
    """Median wall time of each compiled fn, timed in turns (a, b, b, a)
    after one warm-up call each; every call ends in block_until_ready."""
    import jax
    for f in fns.values():
        jax.block_until_ready(f(*args))
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(reps):
        for k in (names if r % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            jax.block_until_ready(fns[k](*args))
            times[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in times.items()}


def _bf16_ulp(x):
    x = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(x)) - 7)


def phase_device() -> dict:
    from lteax.utils.device import nvidia_smi_line, require_gpu
    dev = require_gpu()
    log(f"device: {dev['kind']} x{dev['count']} ({dev['platform']})")
    log(nvidia_smi_line())     # "<name>, <power limit>" per card
    return dev


def phase_turbo(c: int = 3328, k: int = 5824, win: int = 128, acq: int = 16,
                kernel: str = "kernel", reps: int = 10, seed: int = 0):
    """Kernel against plain half-iteration on random channel metrics."""
    import jax
    from lteax.kernels.turbo_mlm import half_iteration, _pin_blane
    n = k + 3
    n_w = -(-n // win)
    log(f"[turbo] half-iteration K={k} win={win} acq={acq} n_w={n_w} C={c}")
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    um = 4.0 * jax.random.normal(ks[0], (win, n_w, c))
    vm = 4.0 * jax.random.normal(ks[1], (win, n_w, c))
    a_l, b_l = _pin_blane(jax.random.normal(ks[2], (n_w, 8, c)),
                          jax.random.normal(ks[3], (n_w, 8, c)))
    args = (um, vm, a_l, b_l)
    live = (np.arange(win)[:, None] + win * np.arange(n_w)[None, :]) < n
    out = {}
    for md in ("f32", "bf16"):
        fns = {}
        for impl in ("plain", kernel):
            f = jax.jit(partial(half_iteration, win=win, acq=acq, n=n,
                                mdtype=md, impl=impl))
            fns[impl] = f.lower(*args).compile()
            log(f"  {md} {impl} memory: {fns[impl].memory_analysis()}")
        res = {i: [np.asarray(x, np.float32) for x in f(*args)]
               for i, f in fns.items()}
        times = _median_times(fns, args, reps)
        lp, lk = res["plain"][0][live], res[kernel][0][live]
        d = np.abs(lk - lp)
        hard = bool(np.array_equal(lk < 0, lp < 0))
        nii = max(float(np.max(np.abs(x - y)))
                  for x, y in zip(res["plain"][1:], res[kernel][1:]))
        log(f"  {md}: max |dL| {float(d.max()):.3e} (max |L| "
            f"{float(np.abs(lp).max()):.3e}), hard bits equal {hard}, "
            f"max |dNII| {nii:.3e}")
        log(f"  {md}: median time plain {times['plain'] * 1e3:.3f} ms, "
            f"{kernel} {times[kernel] * 1e3:.3f} ms")
        check(hard, f"{md} kernel hard bits == plain")
        if md == "f32":
            scale = float(np.abs(lp).max())
            check(float(d.max()) <= 1e-5 * scale,
                  "f32 kernel LLRs within 1e-5 of the plain LLR scale")
            for x, y in zip(res["plain"][1:], res[kernel][1:]):
                check(float(np.max(np.abs(x - y)))
                      <= 1e-5 * max(float(np.abs(x).max()), 1.0),
                      "f32 kernel NII within 1e-5 of the metric scale")
        else:
            check(bool(np.all(d <= 2 * _bf16_ulp(lp))),
                  "bf16 kernel LLRs within 2 ulps of the plain LLRs")
            for x, y in zip(res["plain"][1:], res[kernel][1:]):
                ulp = _bf16_ulp(np.maximum(np.abs(x), np.abs(y)))
                check(bool(np.all(np.abs(x - y) <= 2 * ulp)),
                      "bf16 kernel NII within 2 ulps of the plain NII")
        out[md] = times
    return out


def _decode(dec, x):
    import jax
    t0 = time.perf_counter()
    out = dec(x)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def phase_dl(b: int = 256, n_rb: int = 100, mcs: int = 28,
             snr_db: float = 25.0, n_unique: int = 64,
             interpret: bool = False):
    """DL production decoder vs transmitted bits and the plain decoder."""
    import jax
    from lteax.shard.pipeline import (make_batch_decoder,
                                      make_batch_decoder_pallas)
    from lteax.sim.batches import dl_batch
    batch = dl_batch(b, n_rb=n_rb, mcs=mcs, snr_db=snr_db,
                     n_unique=n_unique)
    log(f"[dl] B={b} {n_rb} PRB MCS {mcs} TBS {batch.geom.tbs} "
        f"C={batch.geom.info.c} K={batch.geom.k} at {snr_db} dB")
    x = jax.device_put(batch.x_iq)
    dec = make_batch_decoder_pallas(*batch.decoder_args(), n_iter=N_ITER,
                                    interpret=interpret)
    (bits, ok), t_first = _decode(dec, x)
    log(f"  compile + first run {t_first:.1f} s; peak device memory "
        f"{_peak_bytes()} B")
    check(int(np.sum(np.asarray(ok))) == b, f"{b}/{b} DL CRCs pass")
    check(np.array_equal(np.asarray(bits), batch.tb_bits),
          "DL bits == transmitted bits")
    plain = make_batch_decoder(*batch.decoder_args(), n_iter=N_ITER)
    (bits_p, ok_p), t_p = _decode(plain, x)
    log(f"  plain decoder compile + first run {t_p:.1f} s")
    check(np.array_equal(np.asarray(bits_p), np.asarray(bits)),
          "DL bits == plain decoder bits")


def phase_others(b: int = 64, n_rb: int = 100, mcs: int = 28,
                 ul_tbs: int = 75376, ul_qm: int = 6, snr_db: float = 25.0,
                 interpret: bool = False, n_unique: int = 16):
    """UL, 2x2 TM3 MIMO and HARQ rv0+rv2 production decoders."""
    import jax
    from lteax.shard.pipeline import (make_batch_harq_decoder_pallas,
                                      make_mimo_batch_decoder,
                                      make_pusch_batch_decoder)
    from lteax.sim.batches import dl_batch, mimo_batch, ul_batch

    alloc, rnti, sf, cid, x_iq, tb = ul_batch(
        b, n_prb=n_rb, tbs=ul_tbs, qm=ul_qm, snr_db=snr_db,
        n_unique=n_unique)
    dec = make_pusch_batch_decoder(alloc, rnti, sf, cid, n_iter=N_ITER,
                                   interpret=interpret)
    (bits, ok), t = _decode(dec, jax.device_put(x_iq))
    log(f"[ul] B={b} {n_rb} PRB TBS {ul_tbs}: first run {t:.1f} s")
    check(int(np.sum(np.asarray(ok))) == b
          and np.array_equal(np.asarray(bits), tb), f"UL {b}/{b} exact")

    mb = mimo_batch(b, n_rb=n_rb, mcs=mcs, snr_db=snr_db, n_unique=n_unique)
    dec = make_mimo_batch_decoder(*mb.decoder_args(), n_iter=N_ITER,
                                  interpret=interpret)
    (bits, ok), t = _decode(dec, jax.device_put(mb.x_iq))
    log(f"[mimo] TM3 2 codewords B={b}: first run {t:.1f} s")
    want = mb.tb_bits.transpose(1, 0, 2).reshape(2 * b, -1)
    check(int(np.sum(np.asarray(ok))) == 2 * b
          and np.array_equal(np.asarray(bits), want),
          f"MIMO {2 * b}/{2 * b} exact")

    hb = dl_batch(b, n_rb=n_rb, mcs=mcs, snr_db=snr_db, n_unique=n_unique,
                  sfs_rvs=((1, 0), (2, 2)))
    dec = make_batch_harq_decoder_pallas(*hb.decoder_args(), n_iter=N_ITER,
                                         interpret=interpret)
    (bits, ok), t = _decode(dec, jax.device_put(hb.x_iq))
    log(f"[harq] rv0+rv2 B={b}: first run {t:.1f} s")
    check(int(np.sum(np.asarray(ok))) == b
          and np.array_equal(np.asarray(bits), hb.tb_bits),
          f"HARQ {b}/{b} exact")


def phase_cell_search(n_carriers: int = 16, cell_id: int = 101,
                      tac: int = 0x2A2A, frames: int = 4):
    """file_gen -> file_scan through their main(), then a multi-carrier
    PSS detect on the same capture."""
    import jax.numpy as jnp
    from lteax.apps import file_gen, file_scan
    from lteax.io.iq import read_iq
    from lteax.phy.config import PhyConfig
    from lteax.phy.sync import find_pss
    log(f"[scan] 1.4 MHz cell {cell_id}, {frames} frames")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cell.fc32")
        file_gen.main(["--out", path, "--cell-id", str(cell_id),
                       "--tac", hex(tac), "--frames", str(frames)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            file_scan.main([path])
        x = read_iq(path, "fc32")
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(res["n_cell_id"] == cell_id, f"cell id {res['n_cell_id']}")
    check(res["mib"] is not None and res["mib"]["n_rb_dl"] == 6,
          "MIB decoded: 6 PRB")
    check(res["sib1"] is not None and res["sib1"]["tac"] == tac,
          f"SIB1 decoded: TAC {hex(tac)}")
    # carriers: the capture delayed by known offsets plus noise
    rng = np.random.default_rng(1)
    delays = np.arange(n_carriers) * 37
    length = len(x) - int(delays.max())
    caps = np.stack([x[int(len(x) - length - d):len(x) - d]
                     for d in delays[::-1]])[::-1]
    caps = caps + 0.05 * (rng.standard_normal(caps.shape)
                          + 1j * rng.standard_normal(caps.shape))
    n_id_2, start, _ = find_pss(jnp.asarray(caps.astype(np.complex64)),
                                PhyConfig(n_rb_dl=6))
    n_id_2, start = np.asarray(n_id_2), np.asarray(start)
    check(bool(np.all(n_id_2 == cell_id % 3)),
          f"{n_carriers}-carrier PSS: N_id_2 == {cell_id % 3} everywhere")
    # PSS repeats every half frame: starts agree modulo 5 ms
    half_frame = 5 * PhyConfig(n_rb_dl=6).n_samps_subframe
    check(bool(np.all((start - start[0] - delays) % half_frame == 0)),
          "PSS starts follow the carrier delays")


def phase_mesh(n: int = 4, b: int = 64, n_rb: int = 100, mcs: int = 28,
               snr_db: float = 25.0, n_unique: int = 16,
               interpret: bool = False):
    """Sharded DL decode on a 1 x n mesh against the one-device decode,
    and the ppermute halo correlator against its unsharded run."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from lteax.phy.sync import pss_time_filters
    from lteax.shard.halo import overlap_save_correlate
    from lteax.shard.mesh import TIME_AXIS, make_mesh, time_sharding
    from lteax.shard.pipeline import (make_batch_decoder_pallas,
                                      make_sharded_decoder_pallas)
    from lteax.sim.batches import dl_batch
    devs = jax.devices()[:n]
    check(len(devs) == n, f"{n} devices")
    batch = dl_batch(b, n_rb=n_rb, mcs=mcs, snr_db=snr_db,
                     n_unique=n_unique)
    mesh = make_mesh(n_chan=1, n_time=n, devices=devs)
    x = jax.device_put(batch.x_iq, time_sharding(mesh, 3))
    log(f"[mesh] 1x{n}, B={b}; input device_set: "
        f"{sorted(str(d) for d in x.sharding.device_set)}")
    dec = make_sharded_decoder_pallas(mesh, *batch.decoder_args(),
                                      n_iter=N_ITER, interpret=interpret)
    (bits, ok, n_ok), t = _decode(dec, x)
    log(f"  sharded decode first run {t:.1f} s; output device_set: "
        f"{sorted(str(d) for d in bits.sharding.device_set)}")
    check(int(n_ok) == b, f"sharded {int(n_ok)}/{b} CRCs")
    check(np.array_equal(np.asarray(bits), batch.tb_bits),
          "sharded bits == transmitted bits")
    one = make_batch_decoder_pallas(*batch.decoder_args(), n_iter=N_ITER,
                                    interpret=interpret)
    bits1, _ = one(jax.device_put(batch.x_iq, devs[0]))
    check(np.array_equal(np.asarray(bits), np.asarray(bits1)),
          "sharded bits == one-device bits")

    taps = jnp.asarray(pss_time_filters(batch.cfg)[batch.cid % 3])
    cap = batch.x_iq[..., 0] + 1j * batch.x_iq[..., 1]
    cap = cap.astype(np.complex64).reshape(-1)
    cap = cap[:len(cap) // n * n]

    def corr(m, xs):
        f = shard_map(lambda blk: overlap_save_correlate(blk, taps,
                                                         TIME_AXIS),
                      mesh=m, in_specs=(P(TIME_AXIS, None),),
                      out_specs=P(TIME_AXIS, None))
        return np.asarray(jax.jit(f)(xs)).reshape(-1)

    xs = jax.device_put(cap.reshape(n, -1), time_sharding(mesh, 2))
    log(f"  halo correlator input device_set: "
        f"{sorted(str(d) for d in xs.sharding.device_set)}")
    # f32 convolutions on both sides, so the comparison sees the halo
    # exchange and not a TF32 algorithm choice
    with jax.default_matmul_precision("highest"):
        y = corr(mesh, xs)
        mesh1 = make_mesh(n_chan=1, n_time=1, devices=devs[:1])
        y1 = corr(mesh1, jax.device_put(cap.reshape(1, -1), devs[0]))
    err = float(np.max(np.abs(y - y1)) / np.max(np.abs(y1)))
    log(f"  halo correlator: max |dy| / max |y| = {err:.3e}")
    check(err <= 1e-4, "sharded halo correlator == unsharded")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", type=int, default=0,
                    help="run only the sharded phase on this many cards")
    a = ap.parse_args(argv)
    dev = phase_device()
    from lteax.utils.compile_cache import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if a.mesh:
        phase_mesh(a.mesh)
    else:
        phase_turbo()
        phase_dl()
        phase_others()
        phase_cell_search()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
