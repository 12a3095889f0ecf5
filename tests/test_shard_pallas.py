"""Sharded PRODUCTION decoders == single-device production bits.

The multi-device path must be the production path.  These pin sharded ==
unsharded decoded bits for DL, UL and 2x2 MIMO on the 8-virtual-device CPU
mesh, on 1x8 AND 2x4 mesh shapes (the turbo kernel in the Pallas
interpreter; the GPU runs the same kernel compiled by Triton)."""

import numpy as np
import jax
import jax.numpy as jnp

from lteax.shard.mesh import make_mesh
from lteax.shard.pipeline import (
    make_batch_decoder_pallas, make_sharded_decoder_pallas,
    make_pusch_batch_decoder, make_sharded_pusch_decoder,
    make_mimo_batch_decoder, make_sharded_mimo_decoder)

import pytest


def _pdsch_samples(n_sf: int, seed: int):
    from tests.test_shard import _make_pdsch_samples
    return _make_pdsch_samples(n_sf, seed)


@pytest.mark.heavy
def test_sharded_pallas_dl_matches_single_device():
    (cfg, cid, ctrl, prbs, sf, rnti, geom, scheme, x, tb_ref) = \
        _pdsch_samples(8, seed=11)
    x = jnp.asarray(x)
    dec1 = make_batch_decoder_pallas(cfg, cid, ctrl, prbs, sf, rnti, geom,
                                     scheme, n_iter=4, interpret=True)
    bits1, ok1 = dec1(x)
    assert bool(jnp.all(ok1))
    np.testing.assert_array_equal(np.asarray(bits1), tb_ref)

    for n_chan, n_time in ((1, 8), (2, 4)):
        mesh = make_mesh(n_chan=n_chan, n_time=n_time)
        dec = make_sharded_decoder_pallas(mesh, cfg, cid, ctrl, prbs, sf,
                                          rnti, geom, scheme, n_iter=4,
                                          interpret=True)
        bits, ok, n_ok = dec(x)
        assert int(n_ok) == 8, f"mesh {n_chan}x{n_time}: {int(n_ok)}/8"
        np.testing.assert_array_equal(np.asarray(bits), np.asarray(bits1))


def _make_pusch_grids(b: int, seed: int):
    from lteax.phy.channels import pusch
    from lteax.phy.channels.pdsch import pdsch_prepare_cbs
    rng = np.random.default_rng(seed)
    cid, sf, rnti = 214, 4, 0x3D
    alloc = pusch.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=504, qm=2)
    nv = 1e-3
    tbs_bits = rng.integers(0, 2, size=(b, alloc.mcs_tbs)).astype(np.int32)
    grids = []
    for i in range(b):
        cbs = jnp.asarray(pdsch_prepare_cbs(tbs_bits[i], alloc.geom))
        g = pusch.pusch_encode_cbs(cbs, alloc, rnti, sf, cid)
        grids.append(pusch.pusch_add_dmrs(np.asarray(g), alloc, cid, sf))
    x = np.stack(grids)
    x = x + (rng.standard_normal(x.shape)
             + 1j * rng.standard_normal(x.shape)) * np.sqrt(nv / 2)
    x_iq = np.stack([x.real, x.imag], -1).astype(np.float32)
    return alloc, rnti, sf, cid, jnp.asarray(x_iq), tbs_bits


@pytest.mark.heavy
def test_sharded_pallas_ul_matches_single_device():
    alloc, rnti, sf, cid, x_iq, tbs_bits = _make_pusch_grids(8, seed=3)
    dec1 = make_pusch_batch_decoder(alloc, rnti, sf, cid, n_iter=4,
                                    interpret=True)
    bits1, ok1 = dec1(x_iq)
    assert bool(jnp.all(ok1))
    np.testing.assert_array_equal(np.asarray(bits1), tbs_bits)

    mesh = make_mesh(n_chan=2, n_time=4)
    dec = make_sharded_pusch_decoder(mesh, alloc, rnti, sf, cid, n_iter=4,
                                     interpret=True)
    bits, ok, n_ok = dec(x_iq)
    assert int(n_ok) == 8
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(bits1))


def _make_mimo_samples(b: int, seed: int):
    from lteax.phy.config import PhyConfig
    from lteax.phy import seq, mimo
    from lteax.phy.grid import crs_flat_idx, crs_symbols, pdsch_flat_idx
    from lteax.phy.ofdm import subframe_to_samples
    from lteax.phy.channels import pdsch as pdsch_mod
    from lteax.phy.tables.tbs import get_tbs_for_mcs

    rng = np.random.default_rng(seed)
    cfg = PhyConfig(n_rb_dl=6, n_ant=2)
    cid, sf, rnti, cfi = 214, 1, 0x1234, 2
    prbs = tuple(range(6))
    tbs, scheme = get_tbs_for_mcs(6, 6)
    re_idx_np = pdsch_flat_idx(cfg, cid, cfi, prbs, sf)
    qm = {"qpsk": 2, "16qam": 4, "64qam": 6}[scheme]
    geom = pdsch_mod.pdsch_geometry(tbs, len(re_idx_np), qm, 0)
    tb_bits = rng.integers(0, 2, size=(2, b, tbs)).astype(np.int32)
    d = [jax.vmap(lambda cb, q=q: pdsch_mod.pdsch_encode_cbs(
            cb, geom, rnti, sf, cid, scheme, codeword=q))(
            jnp.asarray(np.stack([pdsch_mod.pdsch_prepare_cbs(
                tb_bits[q, i], geom) for i in range(b)])))
         for q in range(2)]
    p0, p1 = mimo.precode_tm3(mimo.layer_map_2cw(d[0], d[1]))
    ports = np.zeros((2, b, cfg.n_sym_subframe * cfg.n_sc), np.complex64)
    for p in range(2):
        vals = []
        for sym in crs_symbols(p, cfg):
            slot = sym // cfg.n_sym_slot
            vals.append(seq.crs_values(cid, 2 * sf + slot,
                                       sym % cfg.n_sym_slot, cfg.n_rb_dl))
        ports[p][:, crs_flat_idx(cfg, cid, p)] = np.concatenate(vals)
    ports[0][:, re_idx_np] = np.asarray(p0)
    ports[1][:, re_idx_np] = np.asarray(p1)
    tx = np.stack([np.asarray(subframe_to_samples(jnp.asarray(
        ports[p].reshape(b, cfg.n_sym_subframe, cfg.n_sc)), cfg))
        for p in range(2)])
    cmat = np.array([[1.0 + 0.1j, 0.3 - 0.25j],
                     [0.2 + 0.3j, -0.95 + 0.1j]], np.complex64)
    nv = 10 ** (-2.5)
    rx = np.einsum("rt,tbn->rbn", cmat, tx)
    rx = rx + (rng.standard_normal(rx.shape)
               + 1j * rng.standard_normal(rx.shape)) * np.sqrt(nv / 2)
    x_iq = np.stack([rx.real, rx.imag], -1).astype(np.float32)
    return (cfg, cid, cfi, prbs, sf, rnti, geom, scheme,
            jnp.asarray(x_iq), tb_bits)


@pytest.mark.heavy
def test_sharded_pallas_mimo_matches_single_device():
    (cfg, cid, cfi, prbs, sf, rnti, geom, scheme, x_iq, tb_bits) = \
        _make_mimo_samples(4, seed=1)
    dec1 = make_mimo_batch_decoder(cfg, cid, cfi, prbs, sf, rnti, geom,
                                   scheme, n_iter=4, interpret=True)
    bits1, ok1 = dec1(x_iq)
    assert np.asarray(ok1).all()

    mesh = make_mesh(n_chan=2, n_time=4)
    dec = make_sharded_mimo_decoder(mesh, cfg, cid, cfi, prbs, sf, rnti,
                                    geom, scheme, n_iter=4, interpret=True)
    bits, ok, n_ok = dec(x_iq)
    assert int(n_ok) == 2 * 4        # 2 codewords x 4 subframes
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(bits1))


@pytest.mark.heavy
def test_sharded_mimo_sic_dispatch_and_matches_single_device():
    """A tuning profile selecting mimo_detector="sic" must reach the SIC
    decoder under shard_map and produce single-device-SIC bits."""
    from dataclasses import replace
    from lteax.phy.tuning import DecoderTuning

    (cfg, cid, cfi, prbs, sf, rnti, geom, scheme, x_iq, tb_bits) = \
        _make_mimo_samples(4, seed=2)
    t = replace(DecoderTuning(), mimo_detector="sic")
    dec1 = make_mimo_batch_decoder(cfg, cid, cfi, prbs, sf, rnti, geom,
                                   scheme, n_iter=4, tuning=t,
                                   interpret=True)
    bits1, ok1 = dec1(x_iq)
    assert np.asarray(ok1).all()

    for n_chan, n_time in ((2, 4), (4, 2)):
        mesh = make_mesh(n_chan=n_chan, n_time=n_time)
        dec = make_sharded_mimo_decoder(mesh, cfg, cid, cfi, prbs, sf, rnti,
                                        geom, scheme, n_iter=4, tuning=t,
                                        interpret=True)
        # dispatch check: the SIC decoder exposes its 5 chained programs
        assert hasattr(dec, "stages") and len(dec.stages) == 5
        bits, ok, n_ok = dec(x_iq)
        assert int(n_ok) == 2 * 4, f"mesh {n_chan}x{n_time}: {int(n_ok)}/8"
        np.testing.assert_array_equal(np.asarray(bits), np.asarray(bits1))


@pytest.mark.heavy
def test_sharded_acquire_decode_composed():
    """make_sharded_acquire_decoder_pallas: ppermute halo PSS acquisition
    composed with the production decode front in one sharded program —
    bits exact, CRC metric psum'd, PSS peak found (the dryrun path, under
    CI at small geometry)."""
    from lteax.shard.pipeline import make_sharded_acquire_decoder_pallas

    (cfg, cid, ctrl, prbs, sf, rnti, geom, scheme, x, tb_ref) = \
        _pdsch_samples(8, seed=13)
    mesh = make_mesh(n_chan=1, n_time=8)
    dec = make_sharded_acquire_decoder_pallas(
        mesh, cfg, cid, ctrl, prbs, sf, rnti, geom, scheme, n_iter=4,
        interpret=True)
    bits, ok, n_ok, peak = dec(jnp.asarray(x))
    assert int(n_ok) == 8
    np.testing.assert_array_equal(np.asarray(bits), tb_ref)
    assert float(peak) > 0.0
