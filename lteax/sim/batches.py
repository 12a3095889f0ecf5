"""Encoded, noisy subframe batches for the production decoders.

Each builder draws random transport blocks from ``seed``, encodes
``n_unique`` distinct subframes through the transmit chain, tiles them to
the batch size and adds fresh AWGN to every subframe, so each row of the
batch is a distinct noisy receive.  The benches, ``chip_smoke.py`` and the
tests share them; encoding runs on the default device.

All IQ comes back as float32 pairs (``io.iq.to_iq_f32`` layout).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DlBatch:
    cfg: object
    cid: int
    cfi: int
    prbs: tuple
    sf: int
    rnti: int
    geom: object
    scheme: str
    x_iq: np.ndarray          # (B, n_samps, 2) f32, or (2rx, B, ...) MIMO
    tb_bits: np.ndarray       # (B, TBS) int32, or (2cw, B, TBS) MIMO

    def decoder_args(self):
        """Positional args shared by the DL decoder factories."""
        return (self.cfg, self.cid, self.cfi, self.prbs, self.sf, self.rnti,
                self.geom, self.scheme)


def _tile(x, b, axis=0):
    reps = -(-b // x.shape[axis])
    return np.take(np.concatenate([x] * reps, axis=axis), np.arange(b),
                   axis=axis)


def _awgn(x, nv, rng):
    noise = rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)
    return x + noise * np.sqrt(nv / 2)


def _iq(x):
    return np.stack([x.real, x.imag], -1).astype(np.float32)


def _crs_grid(cfg, cid, sf, port, b):
    """(b, n_sym*n_sc) complex64 grids holding one port's CRS."""
    from lteax.phy import seq
    from lteax.phy.grid import crs_flat_idx, crs_symbols
    vals = []
    for sym in crs_symbols(port, cfg):
        slot = sym // cfg.n_sym_slot
        vals.append(seq.crs_values(cid, 2 * sf + slot, sym % cfg.n_sym_slot,
                                   cfg.n_rb_dl))
    grids = np.zeros((b, cfg.n_sym_subframe * cfg.n_sc), np.complex64)
    grids[:, crs_flat_idx(cfg, cid, port)] = np.concatenate(vals)
    return grids


def _encode(tb_bits, geom, rnti, sf, cid, scheme, codeword=0):
    """(b, TBS) -> (b, n_re) PDSCH symbols."""
    import jax
    import jax.numpy as jnp
    from lteax.phy.channels import pdsch as pdsch_mod
    cbs = np.stack([pdsch_mod.pdsch_prepare_cbs(t, geom) for t in tb_bits])
    enc = jax.jit(jax.vmap(lambda cb: pdsch_mod.pdsch_encode_cbs(
        cb, geom, rnti, sf, cid, scheme, codeword=codeword)))
    return np.asarray(enc(jnp.asarray(cbs)))


def _to_samples(grids, cfg):
    import jax.numpy as jnp
    from lteax.phy.ofdm import subframe_to_samples
    b = grids.shape[0]
    return np.asarray(subframe_to_samples(jnp.asarray(
        grids.reshape(b, cfg.n_sym_subframe, cfg.n_sc)), cfg))


def dl_batch(b: int, n_rb: int = 100, mcs: int = 28, snr_db: float = 25.0,
             seed: int = 0, n_unique: int = 64, cid: int = 214, sf: int = 1,
             rnti: int = 0x1234, cfi: int = 1, rv: int = 0,
             sfs_rvs: tuple | None = None) -> DlBatch:
    """Single-antenna PDSCH subframes, full-band allocation at ``mcs``.

    ``sfs_rvs``: ((subframe, rv), ...) builds one batch per HARQ
    transmission of the same transport blocks; x_iq is then
    (n_tx, B, n_samps, 2) and ``geom`` a tuple of per-transmission
    geometries (``sf`` becomes the tuple of subframes)."""
    from lteax.phy.config import PhyConfig
    from lteax.phy.grid import pdsch_flat_idx
    from lteax.phy.channels import pdsch as pdsch_mod
    from lteax.phy.tables.tbs import get_tbs_for_mcs

    cfg = PhyConfig(n_rb_dl=n_rb)
    prbs = tuple(range(n_rb))
    tbs, scheme = get_tbs_for_mcs(mcs, n_rb)
    qm = {"qpsk": 2, "16qam": 4, "64qam": 6}[scheme]
    rng = np.random.default_rng(seed)
    n_u = min(b, n_unique)
    tb_u = rng.integers(0, 2, size=(n_u, tbs)).astype(np.int32)
    nv = 10 ** (-snr_db / 10)
    txs, geoms = [], []
    for sf_i, rv_i in (sfs_rvs or ((sf, rv),)):
        re_idx = pdsch_flat_idx(cfg, cid, cfi, prbs, sf_i)
        geom = pdsch_mod.pdsch_geometry(tbs, len(re_idx), qm, rv_i)
        grids = _crs_grid(cfg, cid, sf_i, 0, n_u)
        grids[:, re_idx] = _encode(tb_u, geom, rnti, sf_i, cid, scheme)
        x = _tile(_to_samples(grids, cfg), b)
        txs.append(_iq(_awgn(x, nv, rng)))
        geoms.append(geom)
    if sfs_rvs is None:
        return DlBatch(cfg, cid, cfi, prbs, sf, rnti, geoms[0], scheme,
                       txs[0], _tile(tb_u, b))
    return DlBatch(cfg, cid, cfi, prbs, tuple(s for s, _ in sfs_rvs), rnti,
                   tuple(geoms), scheme, np.stack(txs), _tile(tb_u, b))


def mimo_batch(b: int, n_rb: int = 100, mcs: int = 28, snr_db: float = 25.0,
               seed: int = 0, n_unique: int = 16, tm: int = 3,
               cb_index: int = 0, cmat=None, cid: int = 214, sf: int = 1,
               rnti: int = 0x1234, cfi: int = 1) -> DlBatch:
    """2x2 two-codeword PDSCH (TM3 CDD, or TM4 codebook ``cb_index``)
    through a fixed 2x2 channel ``cmat`` (default well-conditioned).
    x_iq (2rx, B, n_samps, 2); tb_bits (2cw, B, TBS)."""
    from lteax.phy import mimo
    from lteax.phy.config import PhyConfig
    from lteax.phy.grid import pdsch_flat_idx
    from lteax.phy.channels import pdsch as pdsch_mod
    from lteax.phy.tables.tbs import get_tbs_for_mcs

    cfg = PhyConfig(n_rb_dl=n_rb, n_ant=2)
    prbs = tuple(range(n_rb))
    tbs, scheme = get_tbs_for_mcs(mcs, n_rb)
    qm = {"qpsk": 2, "16qam": 4, "64qam": 6}[scheme]
    re_idx = pdsch_flat_idx(cfg, cid, cfi, prbs, sf)
    geom = pdsch_mod.pdsch_geometry(tbs, len(re_idx), qm, 0)
    rng = np.random.default_rng(seed)
    n_u = min(b, n_unique)
    tb_u = rng.integers(0, 2, size=(2, n_u, tbs)).astype(np.int32)
    d = [_encode(tb_u[q], geom, rnti, sf, cid, scheme, codeword=q)
         for q in range(2)]
    lm = mimo.layer_map_2cw(d[0], d[1])
    p0, p1 = (mimo.precode_tm3(lm) if tm == 3
              else mimo.precode_tm4(lm, cb_index))
    tx = []
    for p, sym in ((0, p0), (1, p1)):
        grids = _crs_grid(cfg, cid, sf, p, n_u)
        grids[:, re_idx] = np.asarray(sym)
        tx.append(_to_samples(grids, cfg))
    if cmat is None:
        cmat = np.array([[1.0 + 0.1j, 0.3 - 0.25j],
                         [0.2 + 0.3j, -0.95 + 0.1j]], np.complex64)
    rx = _tile(np.einsum("rt,tbn->rbn", cmat, np.stack(tx)), b, axis=1)
    rx = _awgn(rx, 10 ** (-snr_db / 10), rng)
    return DlBatch(cfg, cid, cfi, prbs, sf, rnti, geom, scheme, _iq(rx),
                   _tile(tb_u, b, axis=1))


def ul_batch(b: int, n_prb: int = 100, tbs: int = 75376, qm: int = 6,
             snr_db: float = 25.0, seed: int = 0, n_unique: int = 16,
             cid: int = 214, sf: int = 4, rnti: int = 0x3D):
    """PUSCH grids.  Returns (alloc, rnti, sf, cid, x_iq (B, 14, m_sc, 2),
    tb_bits (B, TBS))."""
    import jax.numpy as jnp
    from lteax.phy.channels import pusch
    from lteax.phy.channels.pdsch import pdsch_prepare_cbs

    alloc = pusch.PuschAlloc(n_prb=n_prb, rb_start=0, mcs_tbs=tbs, qm=qm)
    rng = np.random.default_rng(seed)
    n_u = min(b, n_unique)
    tb_u = rng.integers(0, 2, size=(n_u, tbs)).astype(np.int32)
    grids = []
    for t in tb_u:
        cbs = jnp.asarray(pdsch_prepare_cbs(t, alloc.geom))
        g = pusch.pusch_encode_cbs(cbs, alloc, rnti, sf, cid)
        grids.append(pusch.pusch_add_dmrs(np.asarray(g), alloc, cid, sf))
    x = _awgn(_tile(np.stack(grids), b), 10 ** (-snr_db / 10), rng)
    return alloc, rnti, sf, cid, _iq(x), _tile(tb_u, b)
