"""Config #2 gate: AWGN BLER waterfall POSITION of the PRODUCTION decoder
(Pallas turbo, shipped DecoderTuning: bf16 trellis, pinpad, early stop,
compacted retry) is pinned against the stored curve (docs/bler_awgn.csv)
with a ±0.5 dB tolerance that is derived PROGRAMMATICALLY from the stored
points.

Method: for each constellation the gate measures BLER at three stored
SNR points — the waterfall TOP (stored BLER >= 0.8), the MID point
(0 < stored BLER < 1) and the first ZERO point + 0.5 dB — over two seeds
(2 x 24 = 48 blocks/point).  The tolerance band at each point is
[stored(s + 0.5 dB) - margin, stored(s - 0.5 dB) + margin]: exactly the
BLER range a <= 0.5 dB horizontal shift of the stored curve could produce,
plus binomial sampling margin.  A shift > 0.5 dB in either direction
escapes the band at the zero+0.5 (degradation) or top (fake-improvement /
broken-CRC) point and fails CI."""

import os
import re

import numpy as np
import pytest

from bench.snr_sweep import sweep

_CSV = os.path.join(os.path.dirname(__file__), "..", "docs", "bler_awgn.csv")
_MARGIN = 0.15          # binomial noise at 48 blocks (3.6 sigma at p=0.5)
_STEP = 0.5             # stored curve spacing == the tolerance in dB


def _stored_production_curves():
    """Parse the PRODUCTION section of docs/bler_awgn.csv ->
    {(n_rb, mcs): [(esn0_db, ber, bler), ...]} (sorted by SNR)."""
    curves, key, in_prod = {}, None, False
    with open(_CSV) as f:
        for line in f:
            line = line.strip()
            if "PRODUCTION decoder curve" in line:
                in_prod = True
                continue
            if not in_prod:
                continue
            m = re.match(r"#\s*n_rb=(\d+)\s+mcs=(\d+)", line)
            if m:
                key = (int(m.group(1)), int(m.group(2)))
                curves[key] = []
                continue
            if line.startswith("#") or not line:
                continue
            snr, ber, bler = (float(v) for v in line.split(","))
            curves[key].append((snr, ber, bler))
    assert curves, "no PRODUCTION section found in bler_awgn.csv"
    return {k: sorted(v) for k, v in curves.items()}


def _interp_bler(curve, snr):
    """Stored BLER at an arbitrary SNR (linear interp, clamped ends)."""
    xs = [p[0] for p in curve]
    ys = [p[2] for p in curve]
    return float(np.interp(snr, xs, ys))


def _gate_points(curve):
    """(top, mid, zero+0.5) SNRs with their ±0.5 dB-shift tolerance bands."""
    top = next(s for s, _, bl in curve if bl >= 0.8)
    zero = next(s for s, _, bl in curve if bl == 0.0)
    mids = [(abs(bl - 0.5), s) for s, _, bl in curve
            if 0.0 < bl < 1.0 and top < s < zero]
    assert mids, (top, zero, curve)
    mid = min(mids)[1]
    pts = []
    for s in (top, mid, zero + _STEP):
        lo = _interp_bler(curve, s + _STEP) - _MARGIN
        hi = _interp_bler(curve, s - _STEP) + _MARGIN
        pts.append((s, max(0.0, lo), min(1.0, hi) if hi < 1.0 else 1.0))
    return pts, zero


def _run_gate(n_rb, mcs, expect_scheme):
    curve = _stored_production_curves()[(n_rb, mcs)]
    pts, zero = _gate_points(curve)
    snrs = [s for s, _, _ in pts]
    blers = np.zeros(len(snrs))
    bers = np.zeros(len(snrs))
    seeds = (2, 5)
    for seed in seeds:
        tbs, scheme, res = sweep(n_rb=n_rb, mcs=mcs, n_blocks=24,
                                 n_iter=6, esn0_points=snrs, seed=seed,
                                 decoder="pallas")
        assert scheme == expect_scheme
        blers += np.array([r[2] for r in res]) / len(seeds)
        bers += np.array([r[1] for r in res]) / len(seeds)
    for (s, lo, hi), bler in zip(pts, blers):
        assert lo <= bler <= hi, (
            f"{expect_scheme} BLER at {s:+.1f} dB = {bler:.3f} outside the "
            f"±{_STEP} dB-shift band [{lo:.3f}, {hi:.3f}] "
            f"(stored curve {curve})")
    # the zero+0.5 point must also be bit-clean (catches an error floor the
    # BLER band alone could miss at this block count)
    assert bers[-1] == 0.0, f"BER at {snrs[-1]:+.1f} dB = {bers[-1]}"


@pytest.mark.mid
def test_bler_gate_qpsk_production():
    _run_gate(n_rb=6, mcs=4, expect_scheme="qpsk")


@pytest.mark.mid
def test_bler_gate_16qam_production():
    _run_gate(n_rb=25, mcs=10, expect_scheme="16qam")


@pytest.mark.slow
def test_bler_waterfall_position_device_decoder():
    """The XLA-scan reference decoder keeps its own (coarser) smoke gate."""
    tbs, scheme, res = sweep(n_rb=6, mcs=5, n_blocks=6, n_iter=6,
                             esn0_points=[-4.0, 3.0], seed=1)
    assert scheme == "qpsk"
    low, high = res[0], res[1]
    assert low[2] == 1.0, f"BLER at -4 dB should be 1.0, got {low[2]}"
    assert high[2] == 0.0, f"BLER at +3 dB should be 0.0, got {high[2]}"
    assert high[1] == 0.0
