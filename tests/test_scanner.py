"""Multi-carrier scanner + polyphase resampler front-end (config #5 shape)."""

import numpy as np
import jax.numpy as jnp

from lteax.apps.file_gen import GenConfig, generate
from lteax.apps.scanner import Channel, scan_channels
from lteax.kernels.polyphase import resample_poly
from lteax.io.iq import write_iq
from lteax.phy.config import PhyConfig
import pytest


def test_resampler_tone():
    fs_in, fs_out = 20e6, 30.72e6
    f = 1.7e6
    n = 20000
    x = np.exp(2j * np.pi * f * np.arange(n) / fs_in).astype(np.complex64)
    y = np.asarray(resample_poly(jnp.asarray(x), 192, 125))
    seg = y[2000:12000]
    m = np.arange(2000, 12000)
    fest = np.polyfit(m, np.unwrap(np.angle(seg)), 1)[0] * fs_out / (2 * np.pi)
    assert abs(fest - f) < 100.0
    assert abs(np.abs(seg).mean() - 1.0) < 1e-3
    assert np.abs(seg).std() < 1e-3


@pytest.mark.heavy
def test_scanner_two_channels_with_resampled_capture(tmp_path):
    cfg = PhyConfig(n_rb_dl=6)
    # channel A: native-rate capture
    xa = generate(GenConfig(n_rb_dl=6, n_cell_id=21, n_frames=4, tac=0xA))
    pa = str(tmp_path / "a.fc32")
    write_iq(pa, xa)
    # channel B: "SDR" capture at 2.4 Msps (1.92 * 5/4), scanner resamples back
    xb = generate(GenConfig(n_rb_dl=6, n_cell_id=404, n_frames=6, tac=0xB))
    xb_sdr = np.asarray(resample_poly(jnp.asarray(xb), 5, 4))
    pb = str(tmp_path / "b.fc32")
    write_iq(pb, xb_sdr)
    # channel C: dead channel (noise)
    rng = np.random.default_rng(0)
    pc = str(tmp_path / "c.fc32")
    write_iq(pc, 0.01 * (rng.standard_normal(50000)
                         + 1j * rng.standard_normal(50000)).astype(np.complex64))

    reports = scan_channels([
        Channel("300", pa),
        Channel("301", pb, rate_hz=2.4e6),
        Channel("302", pc),
    ], cfg)
    assert reports[0]["n_cell_id"] == 21 and reports[0]["sib1"]["tac"] == 0xA
    assert reports[0]["freq_mhz"] == 2140.0
    assert reports[1]["n_cell_id"] == 404 and reports[1]["sib1"]["tac"] == 0xB
    assert reports[2]["mib"] is None


@pytest.mark.heavy
def test_scanner_checkpoint_resume(tmp_path):
    """Finished channels are skipped on restart (idempotent work units)."""
    cfg = PhyConfig(n_rb_dl=6)
    x = generate(GenConfig(n_rb_dl=6, n_cell_id=5, n_frames=4))
    p = str(tmp_path / "x.fc32")
    write_iq(p, x)
    ck = str(tmp_path / "scan.ckpt.json")
    chans = [Channel("300", p), Channel("301", p)]
    r1 = scan_channels(chans, cfg, checkpoint_path=ck)
    assert all(d["n_cell_id"] == 5 for d in r1)
    # second run: results come from the checkpoint (delete the file to prove
    # no re-scan happens)
    import os
    os.remove(p)
    r2 = scan_channels(chans, cfg, checkpoint_path=ck)
    assert r2 == r1


def test_scanner_prescan_skips_dead_channels(tmp_path):
    cfg = PhyConfig(n_rb_dl=6)
    x = generate(GenConfig(n_rb_dl=6, n_cell_id=44, n_frames=4, tac=0x44))
    rng = np.random.default_rng(1)
    dead = 0.01 * (rng.standard_normal(len(x))
                   + 1j * rng.standard_normal(len(x))).astype(np.complex64)
    pl = str(tmp_path / "live.fc32")
    pd = str(tmp_path / "dead.fc32")
    write_iq(pl, x)
    write_iq(pd, dead)
    from lteax.apps.scanner import scan_channels, Channel
    reports = scan_channels([Channel("300", pl), Channel("301", pd)], cfg,
                            prescan=True)
    assert reports[0]["n_cell_id"] == 44 and reports[0]["sib1"]["tac"] == 0x44
    assert reports[1]["mib"] is None and not reports[1]["prescan"]["detected"]
