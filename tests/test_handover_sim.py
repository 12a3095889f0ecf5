"""Two-cell intra-LTE handover over the live TTI loop:
UE attaches on the SOURCE cell, receives an A3 measConfig over PDSCH,
reports the TARGET cell stronger, gets the handover command
(mobilityControlInfo + securityConfigHO) on the source cell's SRB1,
performs the dedicated-preamble contention-free RACH on the TARGET cell,
and completes with a re-keyed ReconfigurationComplete over the target
cell's TTI loop — with OFDM+AWGN on every PHY leg and the KeNB* chain
asserted end-to-end (33.401 A.5).

(reference capability: beyond openLTE's eNB, which never sent measConfig /
mobilityControlInfo — the liblte_rrc codec carries them; SURVEY.md §2.3
RRC row.)"""

import numpy as np

from lteax.apps.enb_sim import EnbSim, UeSim
from lteax.apps.file_gen import GenConfig
from lteax.phy.channels import prach
from lteax.stack import security
from lteax.stack.rrc_dedicated import MeasResultEutra
from lteax.stack.rrc_proc import EnbRrc, UeRrc
from lteax.stack.users import Hss, UserManager
import pytest


def _run_ttis(enb, ue, rnti, sfn_range, stop=None):
    for sfn in sfn_range:
        for sf in range(10):
            g_ul = ue.ul_tti_grid(sf)
            if g_ul is not None:
                enb.handle_pusch(rnti, g_ul, sf)
            grid = enb.tti_grid(sfn, sf)
            status = ue.handle_grid(grid, sf)
            if status is not None:
                enb.handle_status(rnti, status)
            if stop is not None and stop():
                return True
    return stop() if stop is not None else True


@pytest.mark.heavy
def test_two_cell_handover_over_tti_loop():
    imsi = (0, 0, 1, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0)
    k = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
    opc = bytes.fromhex("cd63cb71954a9f4e48a5994e37a02baf")
    hss = Hss()
    hss.add_user("".join(map(str, imsi)), k.hex(), opc.hex())
    users = UserManager()

    pci_s, pci_t, earfcn_t = 77, 201, 6300
    gc_s = GenConfig(n_rb_dl=6, n_cell_id=pci_s)
    gc_t = GenConfig(n_rb_dl=6, n_cell_id=pci_t)
    src = EnbSim(gc_s, rrc=EnbRrc(hss, users, pci=pci_s, seed=5))
    tgt = EnbSim(gc_t, rrc=EnbRrc(hss, users, pci=pci_t, earfcn=earfcn_t,
                                  seed=6))
    src.rrc.neighbors[pci_t] = earfcn_t
    src.rrc.neighbor_enb[pci_t] = tgt.rrc

    # -- attach on the source cell over the TTI loop --
    rnti = src.handle_prach(rapid=7)
    ue = UeSim(gc_s, rnti, rrc_ue=UeRrc(imsi, k, opc))
    ue.start_attach()
    attached = _run_ttis(
        src, ue, rnti, range(5),
        stop=lambda: (ue.rrc_ue.state == "connected"
                      and src.rrc.proc(rnti) is not None
                      and src.rrc.proc(rnti).state == "attach-done"))
    assert attached, (ue.rrc_ue.state, src.rrc.events)
    k_enb_before = ue.rrc_ue.k_enb
    assert k_enb_before

    # -- A3 measurement configuration over the source PDSCH --
    src._rrc_out(rnti, src.rrc.configure_measurements(rnti))
    assert _run_ttis(src, ue, rnti, range(5, 8),
                     stop=lambda: ue.rrc_ue.meas_config is not None)

    # -- measurement report (target stronger) -> handover command --
    ue._rrc_reply(ue.rrc_ue.measurement_report(
        1, serv_rsrp=50, serv_rsrq=20,
        neigh=(MeasResultEutra(pci_t, rsrp=62),)))
    assert _run_ttis(src, ue, rnti, range(8, 12),
                     stop=lambda: ue.ho_pending is not None)
    assert any(e.startswith("meas-report") for e in src.rrc.events)
    assert any(e.startswith("handover-command target_pci=201")
               for e in src.rrc.events)
    assert any(e.startswith("ho-admit") for e in tgt.rrc.events)
    new_rnti = ue.rrc_ue.c_rnti
    assert new_rnti is not None and ue.rrc_ue.ho_rach is not None
    assert ue.rrc_ue.ho_target == (pci_t, earfcn_t)

    # -- KeNB* chain: both ends derived the same NEW key (33.401 A.5) --
    k_star = security.generate_k_enb_star(k_enb_before, pci_t, earfcn_t)
    assert ue.rrc_ue.k_enb == k_star != k_enb_before
    assert tgt.rrc.proc(new_rnti).k_enb == k_star
    assert src.rrc.proc(rnti) is None          # context left the source

    # -- dedicated-preamble contention-free RACH on the TARGET cell --
    rng = np.random.default_rng(3)
    u_root, ncs = 129, 119
    preamble = ue.rrc_ue.ho_rach[0]
    burst = prach.generate_prach(u_root, preamble, ncs)
    noise = 10 ** (-12 / 10)
    rx = burst + (rng.standard_normal(len(burst))
                  + 1j * rng.standard_normal(len(burst))) * np.sqrt(noise / 2)
    ncp = prach.PRACH_FORMATS[0][0]
    dets = prach.detect_prach(rx[ncp:].astype(np.complex64), u_root, ncs)
    assert dets and max(dets, key=lambda t: t[2])[0] == preamble

    # -- complete on the target cell's TTI loop (re-keyed SRB1) --
    tgt.admit_handover_ue(new_rnti)
    ue2 = ue.handover_retune(gc_t)
    assert _run_ttis(
        tgt, ue2, new_rnti, range(4),
        stop=lambda: "handover-complete" in tgt.rrc.events)
    assert tgt.rrc.proc(new_rnti).state == "attach-done"
    assert "handover-complete" not in src.rrc.events

    # -- user plane resumes on the target cell with the refreshed keys --
    tgt.send_data(new_rnti, b"dl-after-ho")
    ue2.send_ul(b"ul-after-ho")
    _run_ttis(tgt, ue2, new_rnti, range(4, 7))
    assert ue2.data_sdus == [b"dl-after-ho"]
    assert tgt.ues[new_rnti].ul_sdus == [b"ul-after-ho"]
