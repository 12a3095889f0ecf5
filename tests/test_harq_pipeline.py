"""Production HARQ incremental-redundancy combining.

``make_batch_harq_decoder_pallas`` soft-combines rv=0 + rv=2
(re)transmissions in the d domain (sum of per-tx injective de-match
gathers — the batch counterpart of ``soft_dematch_harq``) and decodes the
combined LLRs in one Pallas turbo batch.  The gate decodes at an SNR where
the rv=0-only production decoder FAILS and the combined decode is exact —
proving real IR gain, not just plumbing.

(reference capability: ``liblte/src/liblte_phy.cc :: rate_unmatch_turbo``
circular-buffer soft-combine accumulating retransmissions.)"""

import numpy as np
import jax.numpy as jnp
import pytest

from lteax.phy.config import PhyConfig
from lteax.phy import seq
from lteax.phy.grid import crs_flat_idx, crs_symbols, pdsch_flat_idx
from lteax.phy.ofdm import subframe_to_samples
from lteax.phy.channels import pdsch as pdsch_mod
from lteax.phy.tables.tbs import get_tbs_for_mcs
from lteax.io.iq import to_iq_f32
from lteax.shard.pipeline import (make_batch_decoder_pallas,
                                  make_batch_harq_decoder_pallas)

CFG = dict(cid=150, rnti=0x1234, cfi=2, mcs=9, n_rb=6)


def _make_tx(cfg, cid, cfi, prbs, sf, rnti, geom, scheme, tb_ref, nv, rng):
    """Encoded subframes (CRS + PDSCH at geom.rv) + AWGN -> (B, n, 2) IQ."""
    re_idx = pdsch_flat_idx(cfg, cid, cfi, prbs, sf)
    out = []
    for i in range(tb_ref.shape[0]):
        grid = np.zeros(cfg.n_sym_subframe * cfg.n_sc, np.complex64)
        vals = []
        for sym in crs_symbols(0, cfg):
            slot = sym // cfg.n_sym_slot
            vals.append(seq.crs_values(cid, 2 * sf + slot,
                                       sym % cfg.n_sym_slot, cfg.n_rb_dl))
        grid[crs_flat_idx(cfg, cid, 0)] = np.concatenate(vals)
        grid[re_idx] = np.asarray(pdsch_mod.pdsch_encode(
            tb_ref[i], geom, rnti, sf, cid, scheme))
        out.append(np.asarray(subframe_to_samples(jnp.asarray(
            grid.reshape(cfg.n_sym_subframe, cfg.n_sc)), cfg)))
    x = np.stack(out)
    x = x + (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)
             ).astype(np.complex64) * np.sqrt(nv / 2)
    return jnp.asarray(to_iq_f32(x))


@pytest.mark.mid
def test_harq_combining_decodes_where_rv0_fails():
    cfg = PhyConfig(n_rb_dl=CFG["n_rb"])
    cid, rnti, cfi = CFG["cid"], CFG["rnti"], CFG["cfi"]
    prbs = tuple(range(CFG["n_rb"]))
    tbs, scheme = get_tbs_for_mcs(CFG["mcs"], CFG["n_rb"])
    qm = {"qpsk": 2, "16qam": 4, "64qam": 6}[scheme]
    rng = np.random.default_rng(3)
    b = 4
    subframes, rvs = (1, 2), (0, 2)
    geoms = tuple(pdsch_mod.pdsch_geometry(
        tbs, len(pdsch_flat_idx(cfg, cid, cfi, prbs, sf)), qm, rv)
        for sf, rv in zip(subframes, rvs))
    tb_ref = rng.integers(0, 2, size=(b, tbs)).astype(np.int32)
    nv = 10 ** (-3.0 / 10)     # 3 dB: below the rv0-only threshold (probed:
    #                            0/4 single-rv CRCs, 4/4 combined)
    xs = [_make_tx(cfg, cid, cfi, prbs, sf, rnti, g, scheme, tb_ref, nv, rng)
          for sf, g in zip(subframes, geoms)]

    dec0 = make_batch_decoder_pallas(cfg, cid, cfi, prbs, subframes[0],
                                     rnti, geoms[0], scheme, n_iter=6,
                                     interpret=True)
    _, ok0 = dec0(xs[0])
    n0 = int(np.sum(np.asarray(ok0)))
    assert n0 < b, f"rv0-only decoded {n0}/{b} — SNR no longer below threshold"

    dec_h = make_batch_harq_decoder_pallas(cfg, cid, cfi, prbs, subframes,
                                           rnti, geoms, scheme, n_iter=6,
                                           interpret=True)
    bits, ok = dec_h(jnp.stack(xs))
    assert int(np.sum(np.asarray(ok))) == b
    np.testing.assert_array_equal(np.asarray(bits), tb_ref)


def test_harq_factory_validates_inputs():
    cfg = PhyConfig(n_rb_dl=6)
    prbs = tuple(range(6))
    tbs, scheme = get_tbs_for_mcs(9, 6)
    g = pdsch_mod.pdsch_geometry(
        tbs, len(pdsch_flat_idx(cfg, 150, 2, prbs, 1)), 2, 0)
    with pytest.raises(AssertionError, match=">=2 transmissions"):
        make_batch_harq_decoder_pallas(cfg, 150, 2, prbs, (1,), 0x1234,
                                       (g,), scheme, interpret=True)
