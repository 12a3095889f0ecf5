"""Full RRC + NAS attach over the simulated air interface.

(reference capability: the end-to-end bring-up the reference demonstrates
against commercial phones — ``LTE_fdd_enb_rrc`` connection setup, AKA via
``LTE_fdd_enb_mme``/``_hss``, NAS+AS security activation, and default
bearer reconfiguration — here with BOTH protocol endpoints (EnbRrc/UeRrc
state machines) exchanging real UPER-coded RRC messages that ride actual
PHY transport blocks: CCCH in MAC PDUs, DCCH in RLC-AM + PDCP SRB frames
(EIA2 MAC-I once AS security activates), over PUSCH/PDSCH with AWGN.)

Run:  python -m lteax.apps.rrc_attach_sim
"""

from __future__ import annotations

import os
import sys

import numpy as np

from lteax.apps.attach_sim import _dl_sch, _ul_sch
from lteax.phy.channels import prach
from lteax.stack import mac_pdu, pdcp_pdu, rlc_pdu, security
from lteax.stack.rrc_proc import EnbRrc, UeRrc
from lteax.stack.users import Hss, UserManager

C_RNTI = 0x003D
RA_RNTI = 0x0002
LCID_DCCH = 0x01
# 6-PRB QPSK transport block (as attach_sim): 864 REs -> 1728 coded bits;
# the largest attach message (reconfiguration + protected NAS) is ~90 bytes
DCCH_TBS = 1032


class _SrbLink:
    """One direction of SRB1: PDCP SRB framing (5-bit SN + MAC-I) inside a
    single RLC AM PDU, integrity-protected with EIA2 once keys arrive."""

    def __init__(self, downlink: bool):
        self.downlink = downlink
        self.sn_tx = 0
        self.k_int: bytes | None = None

    def frame(self, sdu: bytes) -> bytes:
        sn = self.sn_tx & 0x1F
        mac_i = b"\x00\x00\x00\x00"
        if self.k_int is not None:
            mac_i = security.eia2(self.k_int, sn, 0,
                                  1 if self.downlink else 0,
                                  bytes([sn]) + sdu)
        pdu = pdcp_pdu.pack_srb(pdcp_pdu.PdcpSrbPdu(sn=sn, data=sdu,
                                                    mac_i=mac_i))
        self.sn_tx += 1
        return rlc_pdu.pack_amd(rlc_pdu.AmdPdu(sn=sn, data=pdu))

    def deframe(self, raw: bytes) -> bytes:
        amd = rlc_pdu.unpack_amd(raw)
        srb = pdcp_pdu.unpack_srb(amd.data)
        if self.k_int is not None:
            want = security.eia2(self.k_int, srb.sn, 0,
                                 1 if self.downlink else 0,
                                 bytes([srb.sn]) + srb.data)
            if want != srb.mac_i:
                raise ValueError("PDCP SRB integrity check failed")
        return srb.data


def run(verbose: bool = True, noise_db: float = 12.0,
        seed: int = 42) -> dict:
    log = (lambda *a: print(*a, file=sys.stderr)) if verbose \
        else (lambda *a: None)
    rng = np.random.default_rng(seed)
    cid = 214
    noise = 10 ** (-noise_db / 10)
    result = {}

    imsi = (0, 0, 1, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0)
    k = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
    opc = bytes.fromhex("cd63cb71954a9f4e48a5994e37a02baf")
    hss = Hss()
    hss.add_user("".join(map(str, imsi)), k.hex(), opc.hex())
    enb = EnbRrc(hss, UserManager(), seed=seed)
    ue = UeRrc(imsi, k, opc)
    dl_srb, ul_srb = _SrbLink(downlink=True), _SrbLink(downlink=False)

    # 1. PRACH -> RAR (MAC, as in attach_sim)
    u_root, ncs, rapid = 129, 119, 3
    burst = prach.generate_prach(u_root, rapid, ncs)
    rx = burst + (rng.standard_normal(len(burst))
                  + 1j * rng.standard_normal(len(burst))) * np.sqrt(noise / 2)
    ncp = prach.PRACH_FORMATS[0][0]
    dets = prach.detect_prach(rx[ncp:].astype(np.complex64), u_root, ncs)
    assert dets and max(dets, key=lambda t: t[2])[0] == rapid
    rar = mac_pdu.pack_rar_pdu([mac_pdu.Rar(rapid=rapid, timing_advance=2,
                                            ul_grant=0x123, tc_rnti=C_RNTI)])
    got = _dl_sch(rar, 256, RA_RNTI, 1, cid, noise, rng)
    assert got is not None
    _, rars = mac_pdu.unpack_rar_pdu(got)
    assert rars[0].tc_rnti == C_RNTI
    log(f"[1] PRACH + RAR: TC-RNTI=0x{C_RNTI:04X}")
    result["rach"] = True

    # 2..N: pump the RRC engines; every message crosses the PHY
    sf = [2]

    def _next_sf() -> int:
        s = sf[0]
        sf[0] = (sf[0] + 1) % 10
        return s

    def _ul(chan: str, raw: bytes) -> list[tuple[str, bytes]]:
        """UE -> eNB over PUSCH."""
        if chan == "ccch":
            pdu = mac_pdu.pack_mac_pdu(
                [mac_pdu.MacSubPdu(mac_pdu.LCID_CCCH, raw)])
        else:
            pdu = mac_pdu.pack_mac_pdu(
                [mac_pdu.MacSubPdu(LCID_DCCH, ul_srb.frame(raw))])
        got = _ul_sch(pdu, DCCH_TBS, C_RNTI, _next_sf(), cid, noise, rng)
        assert got is not None, "PUSCH decode failed"
        sub = mac_pdu.unpack_mac_pdu(got)[0]
        if sub.lcid == mac_pdu.LCID_CCCH:
            return enb.on_ul_ccch(C_RNTI, sub.payload)
        return enb.on_ul_dcch(C_RNTI, ul_srb.deframe(sub.payload))

    def _dl(chan: str, raw: bytes) -> list[tuple[str, bytes]]:
        """eNB -> UE over PDSCH."""
        if chan == "ccch":
            pdu = mac_pdu.pack_mac_pdu(
                [mac_pdu.MacSubPdu(mac_pdu.LCID_CCCH, raw)])
        else:
            pdu = mac_pdu.pack_mac_pdu(
                [mac_pdu.MacSubPdu(LCID_DCCH, dl_srb.frame(raw))])
        got = _dl_sch(pdu, DCCH_TBS, C_RNTI, _next_sf(), cid, noise, rng)
        assert got is not None, "PDSCH decode failed"
        sub = mac_pdu.unpack_mac_pdu(got)[0]
        if sub.lcid == mac_pdu.LCID_CCCH:
            return ue.on_dl_ccch(sub.payload)
        return ue.on_dl_dcch(dl_srb.deframe(sub.payload))

    dl_queue = _ul("ccch", ue.connect())
    n_msgs = 1
    while dl_queue:
        chan, raw = dl_queue.pop(0)
        replies = _dl(chan, raw)
        n_msgs += 1
        # AS security activation point: SMC was just delivered to the UE
        if ue.k_enb and ul_srb.k_int is None:
            _, k_rrc_int, _ = security.generate_as_keys(ue.k_enb)
            ul_srb.k_int = dl_srb.k_int = k_rrc_int
            log("[*] AS security activated: SRB1 EIA2 MAC-I on")
            result["as_security"] = True
        for chan2, up in replies:
            dl_queue.extend(_ul(chan2, up))
            n_msgs += 1
        assert n_msgs < 50

    p = enb.proc(C_RNTI)
    assert ue.state == "connected" and p.state == "attach-done"
    assert ue.k_enb == p.k_enb and ue.ip == p.ip
    log(f"[2] RRC attach complete over the PHY: {n_msgs} messages, "
        f"IP={'.'.join(map(str, ue.ip))}")
    log("    eNB events: " + "; ".join(enb.events))
    log("    UE events:  " + "; ".join(ue.events))
    result["attach"] = True

    # 3. user plane on the new DRB: EEA2-ciphered IP packet UL
    _, _, k_up_enc = security.generate_as_keys(ue.k_enb)
    ip_packet = b"\x45\x00" + bytes(18) + b"ping"
    ciphered = security.eea2(k_up_enc, 0, ue.drb.eps_bearer_identity - 1, 0,
                             ip_packet)
    drb = pdcp_pdu.pack_drb(pdcp_pdu.PdcpDrbPdu(sn=0, data=ciphered))
    got = _ul_sch(drb, 504, C_RNTI, _next_sf(), cid, noise, rng)
    drb_rx = pdcp_pdu.unpack_drb(got[:len(drb)])
    _, _, k_up_e = security.generate_as_keys(p.k_enb)
    assert security.eea2(k_up_e, 0, p.drb.eps_bearer_identity - 1, 0,
                         drb_rx.data) == ip_packet
    log("[3] Ciphered user-plane packet delivered on DRB1")
    result["user_plane"] = True

    # 4. intra-LTE handover over the PHY: A3 meas config -> UE measurement
    #    report -> handover command on the SOURCE cell -> dedicated-preamble
    #    RACH + ReconfigurationComplete on the TARGET cell, with KeNB*
    #    re-keying of SRB1 on both ends (36.331 §5.3.5.4 / 33.401 A.5).
    #    (reference capability: beyond openLTE's eNB, which never sent
    #    measConfig/mobilityControlInfo; the liblte_rrc codec carries them.)
    from lteax.stack.rrc_dedicated import MeasResultEutra

    pci_t, earfcn_t = 350, 6300
    enb.neighbors[pci_t] = earfcn_t
    (chan, raw), = enb.configure_measurements(C_RNTI)
    for chan2, up in _dl(chan, raw):
        assert _ul(chan2, up) == []
    assert ue.meas_config is not None
    log("[4] A3 measurement configuration delivered over PDSCH")

    (_, rep), = ue.measurement_report(
        1, serv_rsrp=50, serv_rsrq=20,
        neigh=(MeasResultEutra(pci_t, rsrp=62),))
    pdu = mac_pdu.pack_mac_pdu(
        [mac_pdu.MacSubPdu(LCID_DCCH, ul_srb.frame(rep))])
    got = _ul_sch(pdu, DCCH_TBS, C_RNTI, _next_sf(), cid, noise, rng)
    sub = mac_pdu.unpack_mac_pdu(got)[0]
    cmds = enb.on_ul_dcch(C_RNTI, ul_srb.deframe(sub.payload))
    assert len(cmds) == 1, "measurement report did not trigger handover"
    # the handover command still rides the SOURCE cell's SRB1
    ho_replies = _dl(*cmds[0])
    new_rnti = ue.c_rnti
    assert new_rnti is not None and ue.ho_rach is not None
    log(f"[5] Handover command over source-cell PDSCH: target PCI {pci_t}, "
        f"new C-RNTI 0x{new_rnti:04X}, dedicated preamble "
        f"{ue.ho_rach[0]}")

    # dedicated-preamble (contention-free) RACH on the TARGET cell
    burst = prach.generate_prach(u_root, ue.ho_rach[0], ncs)
    rx = burst + (rng.standard_normal(len(burst))
                  + 1j * rng.standard_normal(len(burst))) * np.sqrt(noise / 2)
    dets = prach.detect_prach(rx[ncp:].astype(np.complex64), u_root, ncs)
    assert dets and max(dets, key=lambda t: t[2])[0] == ue.ho_rach[0]
    rar = mac_pdu.pack_rar_pdu([mac_pdu.Rar(
        rapid=ue.ho_rach[0], timing_advance=1, ul_grant=0x123,
        tc_rnti=new_rnti)])
    got = _dl_sch(rar, 256, RA_RNTI, 1, pci_t, noise, rng)
    assert got is not None
    _, rars = mac_pdu.unpack_rar_pdu(got)
    assert rars[0].tc_rnti == new_rnti

    # SRB1 re-keys from KeNB* on both ends; PDCP COUNTs restart
    dl_t, ul_t = _SrbLink(downlink=True), _SrbLink(downlink=False)
    _, k_rrc_int_t, _ = security.generate_as_keys(ue.k_enb)
    dl_t.k_int = ul_t.k_int = k_rrc_int_t
    # ReconfigurationComplete on the TARGET cell (pci_t scrambling)
    (chan, comp), = ho_replies
    pdu = mac_pdu.pack_mac_pdu(
        [mac_pdu.MacSubPdu(LCID_DCCH, ul_t.frame(comp))])
    got = _ul_sch(pdu, DCCH_TBS, new_rnti, _next_sf(), pci_t, noise, rng)
    assert got is not None, "target-cell PUSCH decode failed"
    sub = mac_pdu.unpack_mac_pdu(got)[0]
    assert enb.on_ul_dcch(new_rnti, ul_t.deframe(sub.payload)) == []
    p = enb.proc(new_rnti)
    assert p is not None and p.state == "attach-done"
    assert ue.k_enb == p.k_enb
    assert "handover-complete" in enb.events

    # user plane resumes on the target cell with the refreshed keys
    _, _, k_up_t = security.generate_as_keys(ue.k_enb)
    pkt = b"\x45\x00" + bytes(18) + b"pong"
    drb = pdcp_pdu.pack_drb(pdcp_pdu.PdcpDrbPdu(
        sn=0, data=security.eea2(k_up_t, 0, 4, 0, pkt)))
    got = _ul_sch(drb, 504, new_rnti, _next_sf(), pci_t, noise, rng)
    drb_rx = pdcp_pdu.unpack_drb(got[:len(drb)])
    _, _, k_up_e = security.generate_as_keys(p.k_enb)
    assert security.eea2(k_up_e, 0, 4, 0, drb_rx.data) == pkt
    log(f"[6] Handover complete on PCI {pci_t}: dedicated RACH + "
        f"re-keyed SRB1 ReconfigurationComplete + user plane resumed")
    result["handover"] = True
    return result


def main():
    res = run(verbose=True)
    print({"rrc_attach_complete": all(res.values()), **res})


if __name__ == "__main__":
    main()
