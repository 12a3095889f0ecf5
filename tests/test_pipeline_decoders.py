"""Production batch-decoder factories (shard/pipeline.py) end-to-end on CPU.

Small-shape versions of the UL (PUSCH) and 2x2 TM3 MIMO bench chains:
encode -> AWGN -> make_*_batch_decoder (turbo kernel in the Pallas
interpreter) -> exact bit recovery.  These cover the factory plumbing the
benches drive
(hoisted scrambling, de-interleave transpose, batch-level de-match,
chest paths) at suite-friendly sizes."""

import numpy as np
import jax
import jax.numpy as jnp

from lteax.phy.channels import pusch
from lteax.phy.channels.pdsch import pdsch_prepare_cbs
from lteax.shard.pipeline import (make_pusch_batch_decoder,
                                  make_mimo_batch_decoder)
import pytest


def test_pusch_batch_decoder_cpu():
    rng = np.random.default_rng(0)
    cid, sf, rnti = 214, 4, 0x3D
    alloc = pusch.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=504, qm=2)
    geom = alloc.geom
    b = 2
    nv = 1e-3
    tbs_bits = rng.integers(0, 2, size=(b, alloc.mcs_tbs)).astype(np.int32)
    grids = []
    for i in range(b):
        cbs = jnp.asarray(pdsch_prepare_cbs(tbs_bits[i], geom))
        g = pusch.pusch_encode_cbs(cbs, alloc, rnti, sf, cid)
        grids.append(pusch.pusch_add_dmrs(np.asarray(g), alloc, cid, sf))
    x = np.stack(grids)
    x = x + (rng.standard_normal(x.shape)
             + 1j * rng.standard_normal(x.shape)) * np.sqrt(nv / 2)
    x_iq = np.stack([x.real, x.imag], -1).astype(np.float32)

    dec = make_pusch_batch_decoder(alloc, rnti, sf, cid, n_iter=4,
                                   noise_var=nv, interpret=True)
    tb, ok = dec(jnp.asarray(x_iq))
    assert np.all(np.asarray(ok))
    assert np.array_equal(np.asarray(tb), tbs_bits)


@pytest.mark.heavy
def test_mimo_batch_decoder_cpu():
    from lteax.phy.config import PhyConfig
    from lteax.phy import seq, mimo
    from lteax.phy.grid import crs_flat_idx, crs_symbols, pdsch_flat_idx
    from lteax.phy.ofdm import subframe_to_samples
    from lteax.phy.channels import pdsch as pdsch_mod
    from lteax.phy.tables.tbs import get_tbs_for_mcs

    rng = np.random.default_rng(1)
    cfg = PhyConfig(n_rb_dl=6, n_ant=2)
    cid, sf, rnti, cfi = 214, 1, 0x1234, 2
    prbs = tuple(range(6))
    tbs, scheme = get_tbs_for_mcs(6, 6)               # QPSK, small TBS
    re_idx_np = pdsch_flat_idx(cfg, cid, cfi, prbs, sf)
    qm = {"qpsk": 2, "16qam": 4, "64qam": 6}[scheme]
    geom = pdsch_mod.pdsch_geometry(tbs, len(re_idx_np), qm, 0)
    b = 2
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

    dec = make_mimo_batch_decoder(cfg, cid, cfi, prbs, sf, rnti, geom,
                                  scheme, n_iter=4, interpret=True)
    tb, ok = dec(jnp.asarray(x_iq))
    assert np.asarray(ok).all()
    got = np.asarray(tb).reshape(b, 2, tbs)
    for i in range(b):
        for q in range(2):
            assert np.array_equal(got[i, q], tb_bits[q, i])


def test_mimo_sic_batch_decoder_cpu():
    """SIC decoder (decode CW0 -> re-encode -> cancel -> CW1 on MRC):
    exact bits on the small 2x2 TM3 geometry, same contract as the fused
    MMSE decoder."""
    from tests.test_shard_pallas import _make_mimo_samples
    from lteax.shard.pipeline import make_mimo_sic_batch_decoder

    (cfg, cid, cfi, prbs, sf, rnti, geom, scheme, x_iq, tb_bits) = \
        _make_mimo_samples(2, seed=5)
    dec = make_mimo_sic_batch_decoder(cfg, cid, cfi, prbs, sf, rnti, geom,
                                      scheme, n_iter=4, interpret=True)
    tb, ok = dec(x_iq)
    assert np.asarray(ok).all()
    got = np.asarray(tb).reshape(2, 2, geom.tbs)
    for i in range(2):
        for q in range(2):
            assert np.array_equal(got[i, q], tb_bits[q, i])


def test_turbo_reencode_matches_scan_encoder():
    from lteax.phy.fec.turbo import turbo_encode_batch
    from lteax.phy.fec.reencode import turbo_reencode_batch
    rng = np.random.default_rng(0)
    for k in (40, 512, 6144):
        bits = rng.integers(0, 2, size=(2, k)).astype(np.int32)
        ref = np.asarray(turbo_encode_batch(jnp.asarray(bits), k))
        got = np.asarray(turbo_reencode_batch(jnp.asarray(bits), k))
        assert np.array_equal(ref, got), k


@pytest.mark.heavy
def test_mimo_sic_beats_mmse_on_tm4_correlated_channel():
    """The SIC operating regime: TM4 fixed layer mapping
    over a correlated, power-asymmetric channel.  At 16QAM mcs15 / 20 dB
    the linear MMSE demix loses the weak layer entirely (4/8 TBs) while
    SIC decodes all 8 exactly — decode the strong codeword, cancel, and
    the weak one sees a clean MRC channel.  (On TM3 the CDD alternation
    makes both codewords statistically identical and SIC is neutral —
    the TM3 analysis.)"""
    from lteax.phy.config import PhyConfig
    from lteax.phy import seq, mimo
    from lteax.phy.grid import crs_flat_idx, crs_symbols, pdsch_flat_idx
    from lteax.phy.ofdm import subframe_to_samples
    from lteax.phy.channels import pdsch as pdsch_mod
    from lteax.phy.tables.tbs import get_tbs_for_mcs
    from lteax.shard.pipeline import (make_mimo_batch_decoder,
                                      make_mimo_sic_batch_decoder)

    rng = np.random.default_rng(1)
    b = 4
    cfg = PhyConfig(n_rb_dl=6, n_ant=2)
    cid, sf, rnti, cfi = 214, 1, 0x1234, 2
    prbs = tuple(range(6))
    tbs, scheme = get_tbs_for_mcs(15, 6)             # 16QAM
    re_idx_np = pdsch_flat_idx(cfg, cid, cfi, prbs, sf)
    qm = {"qpsk": 2, "16qam": 4, "64qam": 6}[scheme]
    geom = pdsch_mod.pdsch_geometry(tbs, len(re_idx_np), qm, 0)
    tb_bits = rng.integers(0, 2, size=(2, b, tbs)).astype(np.int32)
    d = [jax.vmap(lambda cb, q=q: pdsch_mod.pdsch_encode_cbs(
            cb, geom, rnti, sf, cid, scheme, codeword=q))(
            jnp.asarray(np.stack([pdsch_mod.pdsch_prepare_cbs(
                tb_bits[q, i], geom) for i in range(b)])))
         for q in range(2)]
    p0, p1 = mimo.precode_tm4(mimo.layer_map_2cw(d[0], d[1]), 0)
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
    # column 1 is 0.74-correlated with column 0 at ~4.5 dB less power
    cmat = np.array([[1.0, 0.334], [0.6, 0.608]], np.complex64)
    nv = 10 ** (-20.0 / 10.0)
    rx = np.einsum("rt,tbn->rbn", cmat, tx)
    rx = rx + (rng.standard_normal(rx.shape)
               + 1j * rng.standard_normal(rx.shape)) * np.sqrt(nv / 2)
    x_iq = jnp.asarray(np.stack([rx.real, rx.imag], -1).astype(np.float32))

    mm = make_mimo_batch_decoder(cfg, cid, cfi, prbs, sf, rnti, geom,
                                 scheme, n_iter=6, tm=4, interpret=True)
    _, ok_m = mm(x_iq)
    sic = make_mimo_sic_batch_decoder(cfg, cid, cfi, prbs, sf, rnti, geom,
                                      scheme, n_iter=6, tm=4,
                                      interpret=True)
    tb_s, ok_s = sic(x_iq)
    n_mmse = int(np.sum(np.asarray(ok_m)))
    assert n_mmse <= 6, f"channel too easy: mmse {n_mmse}/8"
    assert np.asarray(ok_s).all(), "SIC must decode all TBs"
    got = np.asarray(tb_s).reshape(b, 2, tbs)
    for i in range(b):
        for q in range(2):
            assert np.array_equal(got[i, q], tb_bits[q, i])


def test_pallas_front_decodes_rv2():
    """The kernel-front production decoder handles non-zero redundancy
    versions (the planar de-match indices are geometry-derived): a single
    rv=2 transmission decodes exactly."""
    from lteax.phy.config import PhyConfig
    from lteax.phy import seq
    from lteax.phy.grid import crs_flat_idx, crs_symbols, pdsch_flat_idx
    from lteax.phy.ofdm import subframe_to_samples
    from lteax.phy.channels import pdsch as pdsch_mod
    from lteax.phy.tables.tbs import get_tbs_for_mcs
    from lteax.shard.pipeline import make_batch_decoder_pallas
    from lteax.io.iq import to_iq_f32

    rng = np.random.default_rng(8)
    cfg = PhyConfig(n_rb_dl=6)
    cid, sf, rnti, mcs, ctrl = 150, 1, 0x1234, 9, 3
    prbs = tuple(range(6))
    tbs, scheme = get_tbs_for_mcs(mcs, 6)
    re_idx = pdsch_flat_idx(cfg, cid, ctrl, prbs, sf)
    geom = pdsch_mod.pdsch_geometry(tbs, len(re_idx), 2, rv=2)
    b = 2
    tb_ref = rng.integers(0, 2, size=(b, tbs)).astype(np.int32)
    sams = []
    for i in range(b):
        grid = np.zeros(cfg.n_sym_subframe * cfg.n_sc, dtype=np.complex64)
        vals = []
        for sym in crs_symbols(0, cfg):
            slot = sym // cfg.n_sym_slot
            vals.append(seq.crs_values(cid, 2 * sf + slot,
                                       sym % cfg.n_sym_slot, cfg.n_rb_dl))
        grid[crs_flat_idx(cfg, cid, 0)] = np.concatenate(vals)
        grid[re_idx] = np.asarray(pdsch_mod.pdsch_encode(
            tb_ref[i], geom, rnti, sf, cid, scheme))
        sams.append(np.asarray(subframe_to_samples(
            jnp.asarray(grid.reshape(cfg.n_sym_subframe, cfg.n_sc)), cfg)))
    x = np.stack(sams)
    x = x + (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)
             ).astype(np.complex64) * np.sqrt(10 ** (-1.5) / 2)
    dec = make_batch_decoder_pallas(cfg, cid, ctrl, prbs, sf, rnti, geom,
                                    scheme, n_iter=4, interpret=True)
    bits, ok = dec(jnp.asarray(to_iq_f32(x)))
    assert bool(jnp.all(ok))
    np.testing.assert_array_equal(np.asarray(bits), tb_ref)


@pytest.mark.mid
def test_layout_glue_matches_natural_path():
    """The layout-domain glue (step-major iteration, composed QPP
    gathers, layout CRC matmul) must reproduce the natural-order path
    bit-for-bit, including when the compacted retry engages on blocks
    that fail iteration 1."""
    from lteax.phy.fec.turbo import turbo_encode
    from lteax.phy.fec.crc import attach_crc_np
    from lteax.kernels.turbo_mlm import turbo_decode_batch_pallas

    rng = np.random.default_rng(7)
    k, c = 128, 6
    payload = rng.integers(0, 2, (c, k - 24)).astype(np.int32)
    bits = np.stack([attach_crc_np(p, "24A") for p in payload])
    d = np.stack([np.asarray(turbo_encode(jnp.asarray(b), k))
                  for b in bits])
    llr = (1 - 2 * d.astype(np.float32)) * 2.0
    # hit a couple of blocks hard enough that iteration 1 fails their CRC
    # (exercises compact_at_l / deeper), leave the rest clean
    llr[:2] += rng.standard_normal(llr[:2].shape).astype(np.float32) * 1.8

    res = {}
    for lay in (False, True):
        out, it = turbo_decode_batch_pallas(
            jnp.asarray(llr), k, n_iter=4, win=32, acq=8,
            early_crc="24A", mdtype="f32", retry_m=2, retry_levels=2,
            layout=lay, return_n_iter=True, interpret=True)
        res[lay] = np.asarray(out)
    assert np.array_equal(res[False], res[True])
    # and both recover the clean blocks exactly
    assert np.array_equal(res[True][2:], bits[2:])


@pytest.mark.mid
def test_layout_glue_fixed_iteration_path():
    """layout=True with early_crc=None (fixed-iteration scan) matches the
    natural fixed path."""
    from lteax.phy.fec.turbo import turbo_encode
    from lteax.kernels.turbo_mlm import turbo_decode_batch_pallas

    rng = np.random.default_rng(9)
    k, c = 104, 4
    bits = rng.integers(0, 2, (c, k)).astype(np.int32)
    d = np.stack([np.asarray(turbo_encode(jnp.asarray(b), k))
                  for b in bits])
    llr = (1 - 2 * d.astype(np.float32)) * 3.0
    llr += rng.standard_normal(llr.shape).astype(np.float32) * 0.8

    outs = [np.asarray(turbo_decode_batch_pallas(
        jnp.asarray(llr), k, n_iter=2, win=32, acq=8,
        early_crc=None, mdtype="f32", retry_m=0, layout=lay,
        interpret=True))
        for lay in (False, True)]
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[1], bits)


@pytest.mark.mid
def test_layout_fixed_iteration_bf16_traces():
    """layout=True + early_crc=None + mdtype='bf16': the fixed-iteration
    layout scan carries the kernel-dtype l2 in a dt_e-typed slot; the
    combination traces and decodes end-to-end."""
    from lteax.phy.fec.turbo import turbo_encode
    from lteax.kernels.turbo_mlm import turbo_decode_batch_pallas

    rng = np.random.default_rng(11)
    k, c = 104, 4
    bits = rng.integers(0, 2, (c, k)).astype(np.int32)
    d = np.stack([np.asarray(turbo_encode(jnp.asarray(b), k))
                  for b in bits])
    llr = (1 - 2 * d.astype(np.float32)) * 3.0
    out = np.asarray(turbo_decode_batch_pallas(
        jnp.asarray(llr), k, n_iter=2, win=32, acq=8,
        early_crc=None, mdtype="bf16", retry_m=0, layout=True,
        interpret=True))
    assert np.array_equal(out, bits)


def test_ul_planar_boundary_matches_composed_path():
    """ul_planar_boundary defaults ON, so the composed-gather path has no
    default coverage — pin that both
    boundaries decode the same batch to the same bits (the planar_spec
    statics compose exactly the ul_inv gather the composed path applies
    at the stage boundary)."""
    from lteax.phy.tuning import DecoderTuning
    rng = np.random.default_rng(5)
    cid, sf, rnti = 214, 4, 0x3D
    alloc = pusch.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=504, qm=2)
    geom = alloc.geom
    b, nv = 3, 2e-2                      # noisy enough to exercise retries
    tbs_bits = rng.integers(0, 2, size=(b, alloc.mcs_tbs)).astype(np.int32)
    grids = []
    for i in range(b):
        cbs = jnp.asarray(pdsch_prepare_cbs(tbs_bits[i], geom))
        g = pusch.pusch_encode_cbs(cbs, alloc, rnti, sf, cid)
        grids.append(pusch.pusch_add_dmrs(np.asarray(g), alloc, cid, sf))
    x = np.stack(grids)
    x = x + (rng.standard_normal(x.shape)
             + 1j * rng.standard_normal(x.shape)) * np.sqrt(nv / 2)
    x_iq = jnp.asarray(np.stack([x.real, x.imag], -1).astype(np.float32))

    outs = {}
    for planar in (True, False):
        t = DecoderTuning.from_env(DecoderTuning(ul_planar_boundary=planar))
        dec = make_pusch_batch_decoder(alloc, rnti, sf, cid, n_iter=4,
                                       noise_var=nv, tuning=t,
                                       interpret=True)
        tb, ok = dec(x_iq)
        outs[planar] = (np.asarray(tb), np.asarray(ok))
    assert np.all(outs[True][1]) and np.all(outs[False][1])
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    np.testing.assert_array_equal(outs[True][0], tbs_bits)


def test_mimo_planar_boundary_matches_composed_path():
    """MIMO analogue of the UL boundary-equality pin
    (mimo_planar_boundary defaults ON)."""
    from tests.test_shard_pallas import _make_mimo_samples
    from lteax.phy.tuning import DecoderTuning

    (cfg, cid, cfi, prbs, sf, rnti, geom, scheme, x_iq, tb_bits) = \
        _make_mimo_samples(2, seed=9)
    outs = {}
    for planar in (True, False):
        t = DecoderTuning.from_env(
            DecoderTuning(mimo_planar_boundary=planar))
        dec = make_mimo_batch_decoder(cfg, cid, cfi, prbs, sf, rnti, geom,
                                      scheme, n_iter=4, tuning=t,
                                      interpret=True)
        tb, ok = dec(x_iq)
        outs[planar] = (np.asarray(tb), np.asarray(ok))
    assert np.all(outs[True][1]) and np.all(outs[False][1])
    np.testing.assert_array_equal(outs[True][0], outs[False][0])
    got = outs[True][0].reshape(2, 2, geom.tbs)
    for i in range(2):
        for q in range(2):
            assert np.array_equal(got[i, q], tb_bits[q, i])
