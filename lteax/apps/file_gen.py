"""DL frame generator: synthesize baseband LTE FDD downlink IQ captures.

(reference capability: ``LTE_fdd_dl_file_gen/src/LTE_fdd_dl_fg_samp_buf.cc ::
work`` + ``python/LTE_fdd_dl_file_gen.py`` — SURVEY.md §3.2.)

Builds PSS/SSS/CRS/PBCH(MIB)/PCFICH/PDCCH(DCI 1A)/PDSCH(SIB1, SIB2) frames
and writes an IQ file.  SIB1 goes in subframe 5 of even frames, SIB2 in
subframe 5 of odd frames (its SI window).  All subframes of a batch are
OFDM-modulated in one device call.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np

from lteax.phy.config import PhyConfig
from lteax.phy import seq
from lteax.phy.grid import (crs_flat_idx, crs_symbols, sync_sc, pss_sym,
                            sss_sym, pbch_flat_idx, pcfich_flat_idx,
                            pdcch_flat_idx, pdsch_flat_idx)
from lteax.phy.ofdm import subframe_to_samples
from lteax.phy.channels import pbch, pcfich, pdcch as pdcch_mod, pdsch as pdsch_mod
from lteax.phy.channels.dci import (Dci1A, dci_1a_pack, Dci1C, dci_1c_pack,
                                    TBS_1C, _n_rb_step)
from lteax.phy.tables.tbs import tbs_1a
from lteax.stack import rrc
from lteax.io.iq import write_iq

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE


@dataclasses.dataclass
class GenConfig:
    n_rb_dl: int = 6
    n_cell_id: int = 0
    n_ant: int = 1
    n_frames: int = 4
    mcc: tuple[int, int, int] = (0, 0, 1)
    mnc: tuple[int, ...] = (0, 1)
    tac: int = 0x1234
    cell_identity: int = 0x0050800
    phich_resource: float = 1.0
    cfi: int = 2
    sib1_mcs: int = 4          # I_TBS for the N_PRB_1A column
    band: int = 1
    extended_cp: bool = False
    si_dci: str = "1a"         # "1a" | "1c" — DCI format used for SI grants
    paging_tmsi: tuple[int, ...] = ()   # S-TMSIs paged in subframe 9
    extra_sibs: tuple = ()     # Sib3..Sib13 bodies carried in SI messages
    # optional multi-SI schedule: ((periodicity_rf, (sib_types...)), ...).
    # Entry 0 is SI message 1 (SIB2 is always prepended to it, 36.331
    # §5.2.3); entries n>=2 are sent in their own SI windows.  None keeps
    # the legacy single-SI behavior (SIB2 + all extra_sibs, sf5 odd frames).
    si_schedule: tuple = ()

    @property
    def phy(self) -> PhyConfig:
        return PhyConfig(n_rb_dl=self.n_rb_dl, n_ant=self.n_ant,
                         extended_cp=self.extended_cp)

    @property
    def ctrl_syms(self) -> int:
        return self.cfi + 1 if self.n_rb_dl <= 10 else self.cfi


def _si_alloc(gc: GenConfig) -> tuple[int, int]:
    """(rb_start, l_crb) used for SIB PDSCH allocations."""
    return 0, min(gc.n_rb_dl, 6)


def build_subframe_grid(gc: GenConfig, sfn: int, sf: int,
                        pbch_quarters: np.ndarray,
                        sib1_bits: np.ndarray, sib2_bits: np.ndarray,
                        paging_bits: np.ndarray | None = None,
                        extra_si_bits: np.ndarray | None = None
                        ) -> np.ndarray:
    """Build one subframe's resource grid (ports superposed: the IQ file
    models a single RX antenna with unit channels from each TX port, which
    is what the reference's file_gen produces for its loopback)."""
    from lteax.phy.chest import precode_sfbc, precode_sfbc_fstd
    cfg = gc.phy
    cid = gc.n_cell_id
    n_ant = gc.n_ant
    ports = np.zeros((n_ant, cfg.n_sym_subframe * cfg.n_sc), dtype=np.complex64)

    def _sfbc_scatter(idx: np.ndarray, syms: jnp.ndarray):
        if n_ant == 1:
            ports[0][idx] = np.asarray(syms)
        elif n_ant == 2:
            p0, p1 = precode_sfbc(syms)
            ports[0][idx] = np.asarray(p0)
            ports[1][idx] = np.asarray(p1)
        else:
            for p, arr in enumerate(precode_sfbc_fstd(syms)):
                ports[p][idx] = np.asarray(arr)

    # CRS per port
    for p in range(n_ant):
        vals = []
        for sym in crs_symbols(p, cfg):
            slot = sym // cfg.n_sym_slot
            vals.append(seq.crs_values(cid, 2 * sf + slot,
                                       sym % cfg.n_sym_slot, cfg.n_rb_dl,
                                       cfg.extended_cp))
        ports[p][crs_flat_idx(cfg, cid, p)] = np.concatenate(vals)

    # sync signals (port 0)
    if sf in (0, 5):
        scs = sync_sc(cfg)
        ports[0][pss_sym(cfg) * cfg.n_sc + scs] = seq.pss_sequence(cid % 3)
        ports[0][sss_sym(cfg) * cfg.n_sc + scs] = seq.sss_sequence(
            cid // 3, cid % 3, sf == 5)

    # PBCH quarter
    if sf == 0:
        q = sfn % 4
        port_syms = pbch.pbch_quarter_to_grid(
            jnp.asarray(pbch_quarters[q]), cfg, cid, n_ant)
        for p in range(n_ant):
            ports[p][pbch_flat_idx(cfg, cid)] = np.asarray(port_syms[p])

    # PCFICH
    _sfbc_scatter(pcfich_flat_idx(cfg, cid),
                  pcfich.pcfich_encode(gc.cfi, cid, sf))

    # SI on PDSCH in subframe 5
    if sf == 5:
        sib_bits = sib1_bits if sfn % 2 == 0 else sib2_bits
        rv = int(np.ceil(1.5 * ((sfn // 2) % 4))) % 4 if sfn % 2 == 0 else 0
        if gc.si_dci == "1c":
            step = _n_rb_step(cfg.n_rb_dl)
            ndl = cfg.n_rb_dl // step
            i_tbs = next(i for i, t in enumerate(TBS_1C)
                         if t >= max(len(sib1_bits), len(sib2_bits)))
            tbs = TBS_1C[i_tbs]
            rb_start, l_crb = 0, ndl * step
            dci_bits = dci_1c_pack(Dci1C(rb_start=0, l_crb=ndl,
                                         i_tbs=i_tbs), cfg.n_rb_dl)
        else:
            tbs = tbs_1a(gc.sib1_mcs, 2)   # TPC LSB 0 -> N_PRB_1A = 2
            rb_start, l_crb = _si_alloc(gc)
            dci_bits = dci_1a_pack(Dci1A(rb_start=rb_start, l_crb=l_crb,
                                         mcs=gc.sib1_mcs, rv=rv, tpc=0),
                                   cfg.n_rb_dl)
        ng = gc.phich_resource
        pd_syms = pdcch_mod.pdcch_encode([(dci_bits, SI_RNTI, 0, 4)], cfg,
                                         cid, gc.ctrl_syms, ng, sf,
                                         n_ant=n_ant)
        pd_idx = pdcch_flat_idx(cfg, cid, gc.ctrl_syms, ng).reshape(-1)
        for p in range(pd_syms.shape[0]):
            ports[p][pd_idx] = np.asarray(pd_syms[p])
        prbs = tuple(range(rb_start, rb_start + l_crb))
        re_idx = pdsch_flat_idx(cfg, cid, gc.ctrl_syms, prbs, sf)
        geom = pdsch_mod.pdsch_geometry(tbs, len(re_idx), 2, rv)
        tb = rrc.pad_to(sib_bits, tbs)
        _sfbc_scatter(re_idx, pdsch_mod.pdsch_encode(
            tb, geom, SI_RNTI, sf, cid, "qpsk"))

    # Additional SI message in its 36.331 §5.2.3 SI window (n>=2 entries of
    # schedulingInfoList; generate() picks the window subframe)
    if extra_si_bits is not None:
        tbs = tbs_1a(gc.sib1_mcs, 2)
        rb_start, l_crb = _si_alloc(gc)
        dci_bits = dci_1a_pack(Dci1A(rb_start=rb_start, l_crb=l_crb,
                                     mcs=gc.sib1_mcs, rv=0, tpc=0),
                               cfg.n_rb_dl)
        ng = gc.phich_resource
        pd_syms = pdcch_mod.pdcch_encode([(dci_bits, SI_RNTI, 0, 4)], cfg,
                                         cid, gc.ctrl_syms, ng, sf,
                                         n_ant=n_ant)
        pd_idx = pdcch_flat_idx(cfg, cid, gc.ctrl_syms, ng).reshape(-1)
        for p in range(pd_syms.shape[0]):
            ports[p][pd_idx] = np.asarray(pd_syms[p])
        prbs = tuple(range(rb_start, rb_start + l_crb))
        re_idx = pdsch_flat_idx(cfg, cid, gc.ctrl_syms, prbs, sf)
        geom = pdsch_mod.pdsch_geometry(tbs, len(re_idx), 2, 0)
        _sfbc_scatter(re_idx, pdsch_mod.pdsch_encode(
            rrc.pad_to(extra_si_bits, tbs), geom, SI_RNTI, sf, cid, "qpsk"))

    # Paging in subframe 9 (PO for Ns=1 class configs)
    if sf == 9 and paging_bits is not None and len(paging_bits):
        step = _n_rb_step(cfg.n_rb_dl)
        ndl = cfg.n_rb_dl // step
        i_tbs = next(i for i, t in enumerate(TBS_1C) if t >= len(paging_bits))
        tbs = TBS_1C[i_tbs]
        dci_bits = dci_1c_pack(Dci1C(rb_start=0, l_crb=ndl, i_tbs=i_tbs),
                               cfg.n_rb_dl)
        ng = gc.phich_resource
        pd_syms = pdcch_mod.pdcch_encode([(dci_bits, P_RNTI, 0, 4)], cfg,
                                         cid, gc.ctrl_syms, ng, sf,
                                         n_ant=n_ant)
        pd_idx = pdcch_flat_idx(cfg, cid, gc.ctrl_syms, ng).reshape(-1)
        for pp in range(pd_syms.shape[0]):
            ports[pp][pd_idx] = np.asarray(pd_syms[pp])
        prbs = tuple(range(0, ndl * step))
        re_idx = pdsch_flat_idx(cfg, cid, gc.ctrl_syms, prbs, sf)
        geom = pdsch_mod.pdsch_geometry(tbs, len(re_idx), 2, 0)
        _sfbc_scatter(re_idx, pdsch_mod.pdsch_encode(
            rrc.pad_to(paging_bits, tbs), geom, P_RNTI, sf, cid, "qpsk"))

    return ports.sum(axis=0).reshape(cfg.n_sym_subframe, cfg.n_sc)


def generate(gc: GenConfig) -> np.ndarray:
    """-> (n_frames * 10 * n_samps_subframe,) complex64 baseband."""
    cfg = gc.phy
    mib = rrc.Mib(n_rb_dl=gc.n_rb_dl, phich_duration_extended=False,
                  phich_resource=gc.phich_resource, sfn=0)
    def _sib_type(s):
        if type(s) in rrc.SIB_EXT_TYPE_INDEX:          # sib12/sib13 (Rel-9)
            return rrc.SIB_EXT_TYPE_INDEX[type(s)] + 12
        return rrc.SIB_TYPE_INDEX[type(s)] + 2

    bodies = {_sib_type(s): s for s in gc.extra_sibs}
    if gc.si_schedule:
        entries = tuple(rrc.SchedulingInfo(p, tuple(ts))
                        for p, ts in gc.si_schedule)
        si_payloads = []
        for j, (p, ts) in enumerate(gc.si_schedule):
            sibs = [bodies[t] for t in ts]
            if j == 0:
                sibs = [rrc.Sib2()] + sibs      # SIB2 rides SI message 1
            si_payloads.append(rrc.pack_si(*sibs))
    else:
        # legacy single-SI: SIB2 + all extra_sibs in one message; the
        # sib-MappingInfo advertises every carried type >= 3 ((3,) default)
        extra_types = tuple(sorted({_sib_type(s)
                                    for s in gc.extra_sibs})) or (3,)
        entries = (rrc.SchedulingInfo(8, extra_types),)
        si_payloads = [rrc.pack_si(rrc.Sib2(), *gc.extra_sibs)]
    sib1 = rrc.Sib1(mcc=gc.mcc, mnc=gc.mnc, tac=gc.tac,
                    cell_identity=gc.cell_identity,
                    freq_band_indicator=gc.band,
                    scheduling=entries)
    sib1_bits = rrc.pack_sib1(sib1)
    sib2_bits = si_payloads[0]
    # auto-raise the SI MCS until every message fits the N_PRB_1A=2 TBS
    need = max(len(sib1_bits), *(len(p) for p in si_payloads))
    while tbs_1a(gc.sib1_mcs, 2) < need:
        gc = dataclasses.replace(gc, sib1_mcs=gc.sib1_mcs + 1)

    def extra_si_at(sfn: int, sf: int) -> np.ndarray | None:
        """SI window placement (36.331 §5.2.3): SI message n (n>=2) in
        window x = (n-1)*w starting at frame SFN % T == floor(x/10),
        transmitted at the first non-reserved subframe of the window."""
        w = sib1.si_window_ms
        for j in range(1, len(si_payloads)):
            t = entries[j].si_periodicity_rf
            x = j * w
            sf_tx = x % 10
            while sf_tx in (0, 5, 9):
                sf_tx = (sf_tx + 1) % 10
            if sfn % t == (x // 10) % t and sf == sf_tx:
                return si_payloads[j]
        return None

    grids = []
    pbch_q = None
    for sfn in range(gc.n_frames):
        if sfn % 4 == 0:
            mib.sfn = sfn
            pbch_q = np.asarray(pbch.pbch_encode_40ms(
                jnp.asarray(rrc.pack_mib(mib)), gc.n_ant, gc.n_cell_id,
                extended_cp=cfg.extended_cp))
        paging_bits = (rrc.pack_paging(rrc.Paging(
            ue_identities=gc.paging_tmsi)) if gc.paging_tmsi else None)
        for sf in range(10):
            grids.append(build_subframe_grid(gc, sfn, sf, pbch_q,
                                             sib1_bits, sib2_bits,
                                             paging_bits,
                                             extra_si_at(sfn, sf)))
    batch = jnp.asarray(np.stack(grids))
    x = np.asarray(subframe_to_samples(batch, cfg))
    return x.reshape(-1)


def main(argv=None):
    p = argparse.ArgumentParser(description="LTE DL IQ file generator")
    p.add_argument("--out", required=True)
    p.add_argument("--n-rb", type=int, default=6)
    p.add_argument("--cell-id", type=int, default=0)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--fmt", choices=("fc32", "sc8"), default="fc32")
    p.add_argument("--tac", type=lambda s: int(s, 0), default=0x1234)
    p.add_argument("--n-ant", type=int, choices=(1, 2, 4), default=1)
    p.add_argument("--extended-cp", action="store_true")
    p.add_argument("--si-dci", choices=("1a", "1c"), default="1a")
    p.add_argument("--cfi", type=int, default=None,
                   help="defaults to 2 (3 for 4-antenna cells)")
    a = p.parse_args(argv)
    cfi = a.cfi if a.cfi is not None else (3 if a.n_ant == 4 else 2)
    gc = GenConfig(n_rb_dl=a.n_rb, n_cell_id=a.cell_id, n_frames=a.frames,
                   tac=a.tac, n_ant=a.n_ant, extended_cp=a.extended_cp,
                   si_dci=a.si_dci, cfi=cfi)
    x = generate(gc)
    write_iq(a.out, x, a.fmt)
    print(f"wrote {len(x)} samples ({a.frames} frames, {gc.phy.fs/1e6:.2f} Msps) to {a.out}")


if __name__ == "__main__":
    main()
