"""File scanner: full cell search + MIB + SIB decode from an IQ capture.

(reference capability: ``LTE_fdd_dl_file_scan/src/LTE_fdd_dl_fs_samp_buf.cc
:: work`` state machine COARSE_TIMING_SEARCH → PSS_AND_FINE_TIMING_SEARCH →
SSS_SEARCH → BCH_DECODE → PDSCH_DECODE_SIB1 → PDSCH_DECODE_SI_GENERIC —
SURVEY.md §3.1, the first path the new framework replicates.)

Design: instead of a sample-driven state machine, the capture is
processed in whole-capture batched stages — one PSS correlation over the full
buffer, then ALL subframes OFDM-demodulated/channel-estimated in one batched
device call, then per-SI-subframe control+shared channel decoding.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from lteax.phy.config import PhyConfig
from lteax.phy import sync, chest
from lteax.phy.grid import (sync_sc, pss_sym, sss_sym, pbch_flat_idx,
                            pcfich_flat_idx, pdcch_flat_idx, pdsch_flat_idx)
from lteax.phy.ofdm import samples_to_subframe
from lteax.phy.channels import pbch, pcfich, pdcch as pdcch_mod, pdsch as pdsch_mod
from lteax.phy.tables.tbs import tbs_1a
from lteax.phy.mod import demodulate_maxlog
from lteax.stack import rrc
from lteax.io.iq import read_iq, chunk_subframes

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE


@dataclasses.dataclass
class ScanResult:
    n_cell_id: int = -1
    n_id_1: int = -1
    n_id_2: int = -1
    cfo_hz: float = 0.0
    frame_start: int = -1
    rsrp_dbfs: float = 0.0      # CRS RE power, dB full-scale
    snr_db: float = 0.0         # CRS-based post-FFT SNR estimate
    evm_pct: float = 0.0        # PBCH equalized-symbol EVM (%)
    mib: rrc.Mib | None = None
    n_ant: int = 0
    sfn: int = -1
    sib1: rrc.Sib1 | None = None
    sib2: rrc.Sib2 | None = None
    sibs: dict = dataclasses.field(default_factory=dict)  # sib3..sib13 bodies
    sib_crc_fails: int = 0
    paging: list | None = None
    # per successful SI PDSCH decode: dict(sf_index [into the frame_start-
    # aligned subframe stream], sf, ctrl, prbs, tbs, rv, tb bits) — consumed
    # by the app==production consistency test (not serialized in to_json)
    si_decodes: list = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        d = {
            "n_cell_id": self.n_cell_id,
            "n_id_1": self.n_id_1,
            "n_id_2": self.n_id_2,
            "cfo_hz": round(self.cfo_hz, 1),
            "frame_start": self.frame_start,
            "rsrp_dbfs": round(self.rsrp_dbfs, 1),
            "snr_db": round(self.snr_db, 1),
            "evm_pct": round(self.evm_pct, 2),
            "sfn": self.sfn,
            "n_ant": self.n_ant,
            "mib": dataclasses.asdict(self.mib) if self.mib else None,
            "sib1": dataclasses.asdict(self.sib1) if self.sib1 else None,
            "sib2": dataclasses.asdict(self.sib2) if self.sib2 else None,
            "sibs": {k: dataclasses.asdict(v) for k, v in self.sibs.items()},
            "sib_crc_fails": self.sib_crc_fails,
            "paging": self.paging,
        }
        return json.dumps(d, default=lambda o: o.hex()
                          if isinstance(o, bytes) else str(o))


def _ctrl_syms(cfi: int, n_rb: int) -> int:
    return cfi + 1 if n_rb <= 10 else cfi


def scan(x: np.ndarray, cfg: PhyConfig, correct_cfo: bool = True,
         cfi_hint: int | None = None, ng: float = 1.0,
         max_si_subframes: int = 64) -> ScanResult:
    res = ScanResult()
    xj = jnp.asarray(x)

    # 1. coarse CFO
    if correct_cfo and len(x) >= 3 * cfg.n_samps_subframe:
        _, cfo = sync.coarse_timing_and_cfo(xj, cfg)
        res.cfo_hz = float(cfo)
        xj = sync.apply_cfo(xj, cfo, cfg.fs)

    # 2. PSS
    nid2, pss_idx, _ = sync.find_pss(xj, cfg)
    n_id_2 = int(nid2)
    sf_start = int(pss_idx) - cfg.symbol_starts_subframe[pss_sym(cfg)]
    if sf_start < 0:
        sf_start += 5 * cfg.n_samps_subframe  # use the next PSS occurrence
    res.n_id_2 = n_id_2

    # 3. SSS — demod the PSS-bearing subframe
    sf_grid = samples_to_subframe(
        xj[sf_start:sf_start + cfg.n_samps_subframe], cfg)
    scs = jnp.asarray(sync_sc(cfg))
    pss_re = sf_grid[pss_sym(cfg), scs]
    sss_re = sf_grid[sss_sym(cfg), scs]
    nid1, half5, _ = sync.sss_detect(sss_re, pss_re, n_id_2)
    n_id_1 = int(nid1)
    res.n_id_1 = n_id_1
    res.n_cell_id = cid = 3 * n_id_1 + n_id_2
    frame_start = sf_start - (5 if bool(half5) else 0) * cfg.n_samps_subframe
    if frame_start < 0:
        frame_start += 10 * cfg.n_samps_subframe
    res.frame_start = frame_start

    # 4. batch-demodulate all whole subframes from frame_start
    sfs = chunk_subframes(np.asarray(xj), cfg.n_samps_subframe, frame_start)
    if len(sfs) < 1:
        return res
    grids = samples_to_subframe(jnp.asarray(sfs), cfg)   # (n_sf, 14, n_sc)

    # 5. MIB from the first subframe 0 — blind over n_ant: SISO-equalized
    #    LLRs for the 1-port hypothesis, SFBC-combined for the 2-port one
    g0 = grids[0]
    h0 = chest.estimate_channel(g0, cfg, cid, 0, port=0)
    h1 = chest.estimate_channel(g0, cfg, cid, 0, port=1)
    h2 = chest.estimate_channel(g0, cfg, cid, 0, port=2)
    h3 = chest.estimate_channel(g0, cfg, cid, 0, port=3)
    nv0 = chest.estimate_noise_var(g0, cfg, cid, 0)
    # signal-quality measurements (reference scanner reports these per cell)
    from lteax.phy.grid import crs_flat_idx
    crs_p = float(jnp.mean(jnp.abs(
        g0.reshape(-1)[jnp.asarray(crs_flat_idx(cfg, cid, 0))]) ** 2))
    res.rsrp_dbfs = 10 * float(np.log10(max(crs_p, 1e-12)))
    res.snr_db = 10 * float(np.log10(max(crs_p / max(float(nv0), 1e-12) - 1.0,
                                         1e-3)))
    pb_idx = jnp.asarray(pbch_flat_idx(cfg, cid))
    y_pb = g0.reshape(-1)[pb_idx]
    llrs_by_ant = {}
    for ant in (1, 2):
        x_eq, eff = chest.equalize_res(y_pb, h0.reshape(-1)[pb_idx],
                                       h1.reshape(-1)[pb_idx], nv0, ant)
        llrs_by_ant[ant] = demodulate_maxlog(x_eq, "qpsk", eff)
    x_eq4, eff4 = chest.combine_sfbc_fstd(
        y_pb, h0.reshape(-1)[pb_idx], h1.reshape(-1)[pb_idx],
        h2.reshape(-1)[pb_idx], h3.reshape(-1)[pb_idx], nv0)
    llrs_by_ant[4] = demodulate_maxlog(x_eq4, "qpsk", eff4)
    mib_bits, n_ant, quarter, ok = pbch.pbch_blind_decode(
        llrs_by_ant, cid, extended_cp=cfg.extended_cp)
    if not ok:
        return res
    # EVM from the winning hypothesis' equalized PBCH symbols vs ideal QPSK
    x_best, _ = (chest.equalize_res(y_pb, h0.reshape(-1)[pb_idx],
                                    h1.reshape(-1)[pb_idx], nv0, n_ant)
                 if n_ant <= 2 else (x_eq4, eff4))
    hard = (jnp.sign(jnp.real(x_best)) + 1j * jnp.sign(jnp.imag(x_best))
            ) / np.sqrt(2)
    res.evm_pct = 100.0 * float(jnp.sqrt(
        jnp.mean(jnp.abs(x_best - hard) ** 2)
        / jnp.maximum(jnp.mean(jnp.abs(hard) ** 2), 1e-12)))
    res.n_ant = n_ant
    mib = rrc.unpack_mib(mib_bits, sfn_mod4=quarter)
    res.mib = mib
    res.sfn = mib.sfn
    if mib.n_rb_dl != cfg.n_rb_dl:
        # capture decoded at a different bandwidth than the cell's: report MIB
        return res

    # 6. SI decode over subframe-5s (n_ant-aware: SISO or SFBC combining)
    ng = mib.phich_resource
    cfg_c = PhyConfig(n_rb_dl=cfg.n_rb_dl, n_ant=n_ant,
                      extended_cp=cfg.extended_cp)
    si_done: set[int] = set()

    def _win_entry(sfn: int, sf: int):
        """Pending n>=2 SI-window entry covering (sfn, sf), else None
        (36.331 §5.2.3: window x=(n-1)*w from frame SFN % T == x//10)."""
        if res.sib1 is None or sf in (0, 5, 9):
            return None
        w = res.sib1.si_window_ms
        for j in range(1, len(res.sib1.scheduling)):
            if j in si_done:
                continue
            t = res.sib1.scheduling[j].si_periodicity_rf
            x = j * w
            rel = (((sfn % t) - (x // 10) % t) * 10 + sf - x % 10) % (t * 10)
            if 0 <= rel < w:
                return j
        return None

    def _all_si_done() -> bool:
        return (res.sib1 is not None
                and len(si_done) >= len(res.sib1.scheduling) - 1)

    for i in range(len(sfs)):
        sf = i % 10
        sfn = mib.sfn + i // 10
        if sf == 9 and res.paging is None and i < max_si_subframes:
            _try_paging(res, grids[i], cfg, cfg_c, cid, sf, n_ant, ng)
        win_j = _win_entry(sfn, sf) if sf != 5 else None
        if (sf != 5 and win_j is None) or res.sib_crc_fails > 8:
            continue
        if res.sib1 is not None and res.sib2 is not None and _all_si_done():
            break
        if i >= max_si_subframes:
            break
        g = grids[i]
        gflat = g.reshape(-1)
        h0f = chest.estimate_channel(g, cfg, cid, sf, port=0).reshape(-1)
        h1f = (chest.estimate_channel(g, cfg, cid, sf, port=1).reshape(-1)
               if n_ant >= 2 else h0f)
        h2f = (chest.estimate_channel(g, cfg, cid, sf, port=2).reshape(-1)
               if n_ant == 4 else h0f)
        h3f = (chest.estimate_channel(g, cfg, cid, sf, port=3).reshape(-1)
               if n_ant == 4 else h0f)
        nv = chest.estimate_noise_var(g, cfg, cid, sf)

        def _eq_llrs(idx, scheme="qpsk"):
            if n_ant == 4:
                x_eq, eff = chest.combine_sfbc_fstd(
                    gflat[idx], h0f[idx], h1f[idx], h2f[idx], h3f[idx], nv)
            else:
                x_eq, eff = chest.equalize_res(gflat[idx], h0f[idx],
                                               h1f[idx], nv, n_ant)
            return demodulate_maxlog(x_eq, scheme, eff)

        cfi_llr = _eq_llrs(jnp.asarray(pcfich_flat_idx(cfg_c, cid)))
        cfi = int(pcfich.pcfich_decode(cfi_llr, cid, sf)[0]) if cfi_hint is None else cfi_hint
        ctrl = _ctrl_syms(cfi, cfg.n_rb_dl)
        # PDCCH: deinterleave SYMBOLS to logical CCE order, then equalize
        pd_idx = jnp.asarray(pdcch_flat_idx(cfg_c, cid, ctrl, ng).reshape(-1))
        y_log = pdcch_mod.unpermute_to_logical(gflat[pd_idx], cfg_c, cid,
                                               ctrl, ng)
        h0_log = pdcch_mod.unpermute_to_logical(h0f[pd_idx], cfg_c, cid,
                                                ctrl, ng)
        h1_log = pdcch_mod.unpermute_to_logical(h1f[pd_idx], cfg_c, cid,
                                                ctrl, ng)
        if n_ant == 4:
            h2_log = pdcch_mod.unpermute_to_logical(h2f[pd_idx], cfg_c, cid,
                                                    ctrl, ng)
            h3_log = pdcch_mod.unpermute_to_logical(h3f[pd_idx], cfg_c, cid,
                                                    ctrl, ng)
            x_eq, eff = chest.combine_sfbc_fstd(y_log, h0_log, h1_log,
                                                h2_log, h3_log, nv)
        else:
            x_eq, eff = chest.equalize_res(y_log, h0_log, h1_log, nv, n_ant)
        pd_llr = demodulate_maxlog(x_eq, "qpsk", eff)
        logical = pdcch_mod.pdcch_descramble_logical(pd_llr, cfg_c, cid,
                                                     ctrl, ng, sf)
        n_cces = pdcch_mod.n_cce(cfg_c, cid, ctrl, ng)
        found = pdcch_mod.pdcch_blind_decode_1a(
            logical, cfg.n_rb_dl, SI_RNTI, n_cces)
        if found:
            dci, _, _ = found[0]
            prbs = tuple(range(dci.rb_start, dci.rb_start + dci.l_crb))
            tbs = tbs_1a(dci.mcs, dci.n_prb_1a)
            rv = dci.rv
        else:
            found_1c = pdcch_mod.pdcch_blind_decode_1c(
                logical, cfg.n_rb_dl, SI_RNTI, n_cces)
            if not found_1c:
                continue
            from lteax.phy.channels.dci import _n_rb_step
            dci, _, _ = found_1c[0]
            step = _n_rb_step(cfg.n_rb_dl)
            prbs = tuple(range(dci.rb_start * step,
                               (dci.rb_start + dci.l_crb) * step))
            tbs = dci.tbs()
            # 1C carries no RV: SI uses the 36.321 SFN-derived RV
            rv = int(np.ceil(1.5 * ((sfn // 2) % 4))) % 4 \
                if sfn % 2 == 0 else 0
        re_idx = pdsch_flat_idx(cfg_c, cid, ctrl, prbs, sf)
        geom = pdsch_mod.pdsch_geometry(tbs, len(re_idx), 2, rv)
        llr = _eq_llrs(jnp.asarray(re_idx))
        tb, okc, _ = pdsch_mod.pdsch_decode_llrs(llr, geom, SI_RNTI, sf, cid)
        if not okc:
            res.sib_crc_fails += 1
            continue
        res.si_decodes.append(dict(sf_index=i, sf=sf, ctrl=ctrl, prbs=prbs,
                                   tbs=tbs, rv=rv, tb=np.asarray(tb)))
        sib1 = rrc.unpack_sib1(tb)
        if sib1 is not None and res.sib1 is None:
            res.sib1 = sib1
            continue
        for name, body in rrc.unpack_si_list(tb):
            if name == "sib2":
                res.sib2 = body
            elif name not in res.sibs:
                res.sibs[name] = body
        if win_j is not None:
            si_done.add(win_j)
    return res


def _try_paging(res, g, cfg, cfg_c, cid, sf, n_ant, ng):
    """Blind-decode a P-RNTI DCI 1C in subframe 9 and parse Paging."""
    from lteax.phy.channels.dci import _n_rb_step
    gflat = g.reshape(-1)
    h0f = chest.estimate_channel(g, cfg, cid, sf, port=0).reshape(-1)
    nv = chest.estimate_noise_var(g, cfg, cid, sf)
    cfi_idx = jnp.asarray(pcfich_flat_idx(cfg_c, cid))
    xcfi, ecfi = chest.equalize_res(gflat[cfi_idx], h0f[cfi_idx],
                                    h0f[cfi_idx], nv, 1)
    cfi = int(pcfich.pcfich_decode(
        demodulate_maxlog(xcfi, "qpsk", ecfi), cid, sf)[0])
    ctrl = _ctrl_syms(cfi, cfg.n_rb_dl)
    pd_idx = jnp.asarray(pdcch_flat_idx(cfg_c, cid, ctrl, ng).reshape(-1))
    y_log = pdcch_mod.unpermute_to_logical(gflat[pd_idx], cfg_c, cid, ctrl, ng)
    h_log = pdcch_mod.unpermute_to_logical(h0f[pd_idx], cfg_c, cid, ctrl, ng)
    x_eq, eff = chest.equalize_res(y_log, h_log, h_log, nv, 1)
    logical = pdcch_mod.pdcch_descramble_logical(
        demodulate_maxlog(x_eq, "qpsk", eff), cfg_c, cid, ctrl, ng, sf)
    found = pdcch_mod.pdcch_blind_decode_1c(
        logical, cfg.n_rb_dl, P_RNTI, pdcch_mod.n_cce(cfg_c, cid, ctrl, ng))
    if not found:
        return
    dci, _, _ = found[0]
    step = _n_rb_step(cfg.n_rb_dl)
    prbs = tuple(range(dci.rb_start * step, (dci.rb_start + dci.l_crb) * step))
    re_idx = jnp.asarray(pdsch_flat_idx(cfg_c, cid, ctrl, prbs, sf))
    xp, ep = chest.equalize_res(gflat[re_idx], h0f[re_idx], h0f[re_idx], nv, 1)
    geom = pdsch_mod.pdsch_geometry(dci.tbs(), len(re_idx), 2, 0)
    tb, okc, _ = pdsch_mod.pdsch_decode_llrs(
        demodulate_maxlog(xp, "qpsk", ep), geom, P_RNTI, sf, cid)
    if okc:
        pg = rrc.unpack_paging(tb)
        if pg is not None:
            res.paging = [hex(t) for t in pg.ue_identities]


def main(argv=None):
    p = argparse.ArgumentParser(description="LTE DL IQ file scanner")
    p.add_argument("path")
    p.add_argument("--n-rb", type=int, default=6,
                   help="bandwidth of the capture (sets sample rate)")
    p.add_argument("--fmt", choices=("fc32", "sc8"), default="fc32")
    p.add_argument("--no-cfo", action="store_true")
    p.add_argument("--extended-cp", action="store_true")
    a = p.parse_args(argv)
    cfg = PhyConfig(n_rb_dl=a.n_rb, extended_cp=a.extended_cp)
    x = read_iq(a.path, a.fmt)
    res = scan(x, cfg, correct_cfo=not a.no_cfo)
    print(res.to_json())


if __name__ == "__main__":
    main()
