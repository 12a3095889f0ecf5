"""OFDM roundtrip, CRS channel estimation, PSS/SSS cell search on a
synthetic frame (SURVEY.md build step 3 gate)."""

import numpy as np
import pytest
import jax.numpy as jnp

from lteax.phy.config import PhyConfig
from lteax.phy.ofdm import subframe_to_samples, samples_to_subframe
from lteax.phy import seq, sync, chest
from lteax.phy.grid import (crs_flat_idx, sync_sc, pss_sym, sss_sym)


CFG = PhyConfig(n_rb_dl=6)


def _build_sync_subframe(cfg, n_id_1, n_id_2, subframe):
    """Grid with CRS + PSS/SSS (+ random QPSK elsewhere left zero)."""
    grid = np.zeros((cfg.n_sym_subframe, cfg.n_sc), dtype=np.complex64)
    n_cell_id = 3 * n_id_1 + n_id_2
    flat = grid.reshape(-1)
    pidx = crs_flat_idx(cfg, n_cell_id, 0)
    vals = []
    from lteax.phy.grid import crs_symbols
    for sym in crs_symbols(0, cfg):
        slot = sym // cfg.n_sym_slot
        ns = 2 * subframe + slot
        vals.append(seq.crs_values(n_cell_id, ns, sym % cfg.n_sym_slot, cfg.n_rb_dl))
    flat[pidx] = np.concatenate(vals)
    grid = flat.reshape(cfg.n_sym_subframe, cfg.n_sc)
    if subframe in (0, 5):
        grid[pss_sym(cfg), sync_sc(cfg)] = seq.pss_sequence(n_id_2)
        grid[sss_sym(cfg), sync_sc(cfg)] = seq.sss_sequence(n_id_1, n_id_2, subframe == 5)
    return grid


def test_ofdm_roundtrip():
    rng = np.random.default_rng(0)
    for nrb in (6, 25):
        cfg = PhyConfig(n_rb_dl=nrb)
        grid = (rng.standard_normal((cfg.n_sym_subframe, cfg.n_sc))
                + 1j * rng.standard_normal((cfg.n_sym_subframe, cfg.n_sc))
                ).astype(np.complex64)
        x = subframe_to_samples(jnp.asarray(grid), cfg)
        assert x.shape == (cfg.n_samps_subframe,)
        back = np.asarray(samples_to_subframe(x, cfg))
        np.testing.assert_allclose(back, grid, atol=1e-4)


def test_pss_detection_and_timing():
    cfg = CFG
    n_id_1, n_id_2 = 17, 1
    grid = _build_sync_subframe(cfg, n_id_1, n_id_2, 0)
    x = np.asarray(subframe_to_samples(jnp.asarray(grid), cfg))
    # embed at an offset inside a longer buffer
    off = 777
    buf = np.zeros(3 * cfg.n_samps_subframe, dtype=np.complex64)
    buf[off:off + len(x)] = x
    nid2, idx, _ = sync.find_pss(jnp.asarray(buf), cfg)
    assert int(nid2) == n_id_2
    expected_start = off + cfg.symbol_starts_subframe[pss_sym(cfg)]
    assert int(idx) == expected_start, (int(idx), expected_start)


def test_sss_detection_both_halves():
    cfg = CFG
    n_id_1, n_id_2 = 42, 2
    for subframe, want_half in ((0, False), (5, True)):
        grid = _build_sync_subframe(cfg, n_id_1, n_id_2, subframe)
        x = subframe_to_samples(jnp.asarray(grid), cfg)
        back = samples_to_subframe(x, cfg)
        scs = jnp.asarray(sync_sc(cfg))
        pss_re = back[pss_sym(cfg), scs]
        sss_re = back[sss_sym(cfg), scs]
        nid1, half, _ = sync.sss_detect(sss_re, pss_re, n_id_2)
        assert int(nid1) == n_id_1
        assert bool(half) == want_half


def test_cfo_estimation_and_correction():
    cfg = CFG
    grid = _build_sync_subframe(cfg, 10, 0, 0)
    x = np.asarray(subframe_to_samples(jnp.asarray(grid), cfg))
    x = np.tile(x, 4)
    f_off = 300.0  # Hz
    n = np.arange(len(x))
    xr = (x * np.exp(2j * np.pi * f_off * n / cfg.fs)).astype(np.complex64)
    _, cfo = sync.coarse_timing_and_cfo(jnp.asarray(xr), cfg)
    assert abs(float(cfo) - f_off) < 50.0, float(cfo)
    xc = sync.apply_cfo(jnp.asarray(xr), cfo, cfg.fs)
    _, cfo2 = sync.coarse_timing_and_cfo(xc, cfg)
    assert abs(float(cfo2)) < 50.0


def test_channel_estimation_flat_and_multipath():
    cfg = CFG
    n_cell_id = 123
    subframe = 3
    grid = _build_sync_subframe(cfg, n_cell_id // 3, n_cell_id % 3, subframe)
    g = jnp.asarray(grid)
    # flat channel
    h_true = np.complex64(0.8 * np.exp(1j * 0.7))
    h = chest.estimate_channel(g * h_true, cfg, n_cell_id, subframe, port=0)
    got = np.asarray(h)
    np.testing.assert_allclose(got, np.full_like(got, h_true), atol=1e-3)
    # frequency-selective: 2-tap channel applied in time domain
    x = subframe_to_samples(g, cfg)
    xm = np.asarray(x)
    y = xm + 0.4 * np.roll(xm, 3)
    back = samples_to_subframe(jnp.asarray(y), cfg)
    h_est = np.asarray(chest.estimate_channel(back, cfg, n_cell_id, subframe, 0))
    # true channel per subcarrier
    imp = np.zeros(cfg.n_fft, dtype=np.complex64)
    imp[0], imp[3] = 1.0, 0.4
    h_freq = np.fft.fft(imp)[cfg.sc_to_fft_bin]
    err = np.abs(h_est[5] - h_freq) / np.abs(h_freq)
    assert np.median(err) < 0.08, np.median(err)


@pytest.mark.parametrize("n_sf", [20, 45])
def test_pss_overlap_save_matches_direct_correlation(n_sf):
    """Captures longer than the one-shot FFT cap go overlap-save with
    fixed-size FFT blocks; |corr|^2 must match a direct numpy FFT
    correlation of the whole capture, and find the embedded replica."""
    from lteax.phy.sync import pss_time_filters, _PSS_FFT_MAX

    cfg = PhyConfig(n_rb_dl=6)
    rng = np.random.default_rng(n_sf)
    filt = pss_time_filters(cfg)
    L = n_sf * cfg.n_samps_subframe
    assert L + cfg.n_fft > _PSS_FFT_MAX
    off = L - 3 * cfg.n_fft - 5
    x = (rng.standard_normal(L)
         + 1j * rng.standard_normal(L)).astype(np.complex64) * 0.05
    x[off:off + cfg.n_fft] += filt[2]
    got = np.asarray(sync.pss_correlate(jnp.asarray(x), cfg))
    nfft = 1 << int(np.ceil(np.log2(L + cfg.n_fft)))
    xf = np.fft.fft(x, nfft)
    hf = np.fft.fft(np.conj(filt[:, ::-1]), nfft, axis=-1)
    ref = np.abs(np.fft.ifft(xf[None] * hf, axis=-1)
                 [:, cfg.n_fft - 1:cfg.n_fft - 1 + L]) ** 2
    np.testing.assert_allclose(got, ref, atol=1e-4 * float(ref.max()))
    assert got[2].argmax() == off
