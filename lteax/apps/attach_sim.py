"""Attach procedure simulator: UE <-> eNB/MME over the actual PHY.

(reference capability: the eNodeB control-plane flow of SURVEY.md §3.3 —
PRACH detect -> MAC RAR -> RRC setup -> NAS attach/AKA/security-mode ->
default bearer — executed here as an in-process simulation over the real
lteax PHY codecs: PRACH, PDCCH+DCI, PDSCH, PUSCH, MAC/RLC/PDCP PDUs, NAS,
Milenage/EIA2/EEA2.  The reference runs this against real phones; this
framework's testable equivalent is this loopback.)

Run:  python -m lteax.apps.attach_sim
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import jax.numpy as jnp

from lteax.phy.channels import prach, pdsch as pdsch_mod, pusch
from lteax.phy.mod import demodulate_maxlog
from lteax.stack import mac_pdu, rlc_pdu, pdcp_pdu, nas, security
from lteax.io.pcap import MacPcapWriter, DIR_DL, DIR_UL, RNTI_RA, RNTI_C

RA_RNTI = 0x0002
C_RNTI = 0x003D


@dataclasses.dataclass
class HssEntry:
    imsi: tuple
    k: bytes
    opc: bytes
    sqn: int = 1


def _dl_sch(tb_bytes: bytes, tbs_bits: int, rnti: int, subframe: int,
            cid: int, noise: float, rng) -> bytes | None:
    """Carry bytes over a PDSCH transport block (encode -> AWGN -> decode)."""
    bits = np.unpackbits(np.frombuffer(tb_bytes, np.uint8))
    assert len(bits) <= tbs_bits, (len(bits), tbs_bits)
    tb = np.zeros(tbs_bits, np.int32)
    tb[:len(bits)] = bits
    n_re = tbs_bits  # QPSK rate 1/2
    geom = pdsch_mod.pdsch_geometry(tbs_bits, n_re, 2, 0)
    sym = pdsch_mod.pdsch_encode(tb, geom, rnti, subframe, cid, "qpsk")
    rx = np.asarray(sym) + (rng.standard_normal(sym.shape)
                            + 1j * rng.standard_normal(sym.shape)
                            ).astype(np.complex64) * np.sqrt(noise / 2)
    llr = demodulate_maxlog(jnp.asarray(rx), "qpsk", noise)
    got, ok, _ = pdsch_mod.pdsch_decode_llrs(llr, geom, rnti, subframe, cid,
                                             n_iter=5)
    if not ok:
        return None
    return np.packbits(got[:len(bits)]).tobytes()[:len(tb_bytes)]


def _ul_sch(tb_bytes: bytes, tbs_bits: int, rnti: int, subframe: int,
            cid: int, noise: float, rng) -> bytes | None:
    """Carry bytes over a PUSCH transport block."""
    bits = np.unpackbits(np.frombuffer(tb_bytes, np.uint8))
    tb = np.zeros(tbs_bits, np.int32)
    tb[:len(bits)] = bits
    alloc = pusch.PuschAlloc(n_prb=6, rb_start=0, mcs_tbs=tbs_bits, qm=2)
    cbs = jnp.asarray(pdsch_mod.pdsch_prepare_cbs(tb, alloc.geom))
    grid = pusch.pusch_encode_cbs(cbs, alloc, rnti, subframe, cid)
    grid = pusch.pusch_add_dmrs(np.asarray(grid), alloc, cid, subframe)
    rx = grid + (rng.standard_normal(grid.shape)
                 + 1j * rng.standard_normal(grid.shape)) * np.sqrt(noise / 2)
    got, ok, _ = pusch.pusch_decode(jnp.asarray(rx.astype(np.complex64)),
                                    alloc, rnti, subframe, cid,
                                    noise_var=noise, n_iter=5)
    if not ok:
        return None
    return np.packbits(np.asarray(got)[:len(bits)]).tobytes()[:len(tb_bytes)]


def run(verbose: bool = True, pcap_path: str | None = None) -> dict:
    log = (lambda *a: print(*a, file=sys.stderr)) if verbose else (lambda *a: None)
    rng = np.random.default_rng(42)
    cid = 214
    noise = 10 ** (-1.2)     # ~12 dB
    pcap = MacPcapWriter(pcap_path) if pcap_path else None
    hss = HssEntry(imsi=(0, 0, 1, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0),
                   k=bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc"),
                   opc=bytes.fromhex("cd63cb71954a9f4e48a5994e37a02baf"))
    result = {}

    # 1. RACH: UE sends preamble, eNB detects
    u_root, ncs, rapid = 129, 119, 3
    burst = prach.generate_prach(u_root, rapid, ncs)
    rx = burst + (rng.standard_normal(len(burst))
                  + 1j * rng.standard_normal(len(burst))) * np.sqrt(noise / 2)
    ncp = prach.PRACH_FORMATS[0][0]
    dets = prach.detect_prach(rx[ncp:].astype(np.complex64), u_root, ncs)
    assert dets and max(dets, key=lambda t: t[2])[0] == rapid
    log(f"[1] PRACH: detected preamble v={rapid}")
    result["prach"] = True

    # 2. RAR on PDSCH @ RA-RNTI
    rar = mac_pdu.pack_rar_pdu([mac_pdu.Rar(rapid=rapid, timing_advance=31,
                                            ul_grant=0x12345,
                                            tc_rnti=C_RNTI)])
    if pcap:
        pcap.write(rar, DIR_DL, RNTI_RA, RA_RNTI, subframe=1)
    got = _dl_sch(rar, 256, RA_RNTI, 1, cid, noise, rng)
    assert got is not None
    _, rars = mac_pdu.unpack_rar_pdu(got)
    assert rars[0].rapid == rapid and rars[0].tc_rnti == C_RNTI
    log(f"[2] RAR decoded: TC-RNTI=0x{rars[0].tc_rnti:04X} TA={rars[0].timing_advance}")
    result["rar"] = True

    # 3. UE -> eNB: RRC connection request (CCCH) + NAS attach request later
    rrc_req = mac_pdu.pack_mac_pdu([mac_pdu.MacSubPdu(
        mac_pdu.LCID_CCCH, b"\x5a\xa5" + bytes(hss.imsi[-5:]))])
    got = _ul_sch(rrc_req, 328, C_RNTI, 2, cid, noise, rng)
    assert got is not None
    sps = mac_pdu.unpack_mac_pdu(got)
    assert sps[0].lcid == mac_pdu.LCID_CCCH
    log("[3] RRC connection request over PUSCH decoded")
    result["rrc_request"] = True

    # 4. NAS attach request (UE) over SRB1: RLC AM + PDCP
    esm = nas.pack_pdn_connectivity_request(nas.PdnConnectivityRequest())
    attach = nas.pack_attach_request(nas.AttachRequest(
        imsi=hss.imsi, esm_container=esm))
    amd = rlc_pdu.pack_amd(rlc_pdu.AmdPdu(sn=0, data=pdcp_pdu.pack_srb(
        pdcp_pdu.PdcpSrbPdu(sn=0, data=attach))))
    got = _ul_sch(amd, 1032, C_RNTI, 3, cid, noise, rng)
    assert got is not None
    amd_rx = rlc_pdu.unpack_amd(got[:len(amd)])
    srb = pdcp_pdu.unpack_srb(amd_rx.data)
    att_rx = nas.unpack_attach_request(srb.data)
    assert att_rx is not None and att_rx.imsi == hss.imsi
    log(f"[4] NAS attach request: IMSI={''.join(map(str, att_rx.imsi))}")
    result["attach_request"] = True

    # 5. AKA: MME builds AUTN/RAND from HSS, UE answers RES
    rand = rng.bytes(16)
    sqn = hss.sqn.to_bytes(6, "big")
    amf = b"\x80\x00"
    res_n, ck, ik, ak = security.milenage_f2345(hss.k, rand, op_c=hss.opc)
    mac_a, _ = security.milenage_f1(hss.k, rand, sqn, amf, op_c=hss.opc)
    autn = bytes(a ^ b for a, b in zip(sqn, ak)) + amf + mac_a
    auth_req = nas.pack_auth_request(nas.AuthRequest(ksi=0, rand=rand,
                                                     autn=autn))
    got = _dl_sch(auth_req, 328, C_RNTI, 4, cid, noise, rng)
    ar = nas.unpack_auth_request(got)
    # UE verifies AUTN and computes RES
    res_u, ck_u, ik_u, ak_u = security.milenage_f2345(hss.k, ar.rand,
                                                      op_c=hss.opc)
    sqn_u = bytes(a ^ b for a, b in zip(ar.autn[:6], ak_u))
    mac_u, _ = security.milenage_f1(hss.k, ar.rand, sqn_u, ar.autn[6:8],
                                    op_c=hss.opc)
    assert mac_u == ar.autn[8:16], "AUTN MAC verification failed"
    auth_resp = nas.pack_auth_response(nas.AuthResponse(res=res_u))
    got = _ul_sch(auth_resp, 256, C_RNTI, 5, cid, noise, rng)
    assert nas.unpack_auth_response(got).res == res_n
    log("[5] AKA complete: AUTN verified, RES matches")
    result["aka"] = True

    # 6. NAS security mode (integrity-protected with derived keys)
    k_asme = security.generate_k_asme(ck, ik, bytes(a ^ b for a, b in
                                                    zip(sqn, ak)),
                                      b"\x00\xf1\x10")
    k_enc, k_int = security.generate_nas_keys(k_asme)
    smc = nas.pack_security_mode_command(nas.SecurityModeCommand(2, 2, 0))
    wire = nas.protect(smc, k_int, count=0, downlink=True, k_nas_enc=k_enc,
                       sec_hdr=nas.SEC_HDR_INTEGRITY_CIPHERED_NEW_CTX)
    got = _dl_sch(wire, 328, C_RNTI, 6, cid, noise, rng)
    plain, ok_mac = nas.unprotect(got, k_int, 0, True, k_nas_enc=k_enc)
    assert ok_mac and nas.unpack_security_mode_command(plain) is not None
    log("[6] NAS security mode: EIA2 MAC verified, EEA2 deciphered")
    result["smc"] = True

    # 7. Attach accept + default bearer; then one ciphered user-plane packet
    bearer = nas.pack_activate_default_bearer_request(
        nas.ActivateDefaultBearerRequest(ebi=5, pti=1, apn="internet",
                                         ip=(10, 0, 0, 2)))
    accept = nas.pack_attach_accept(nas.AttachAccept(
        attach_result=1, t3412_s=3600, tac=0x1234, mcc=(0, 0, 1),
        mnc=(0, 1), esm_container=bearer))
    got = _dl_sch(accept, 1032, C_RNTI, 7, cid, noise, rng)
    acc = nas.unpack_attach_accept(got)
    b = nas.unpack_activate_default_bearer_request(acc.esm_container)
    assert b.apn == "internet" and b.ip == (10, 0, 0, 2)
    k_enb = security.generate_k_enb(k_asme, 1)
    k_rrc_enc, k_rrc_int, k_up_enc = security.generate_as_keys(k_enb)
    ip_packet = b"\x45\x00" + bytes(18) + b"ping"
    ciphered = security.eea2(k_up_enc, 0, 5, 0, ip_packet)
    drb = pdcp_pdu.pack_drb(pdcp_pdu.PdcpDrbPdu(sn=0, data=ciphered))
    got = _ul_sch(drb, 504, C_RNTI, 8, cid, noise, rng)
    drb_rx = pdcp_pdu.unpack_drb(got[:len(drb)])
    assert security.eea2(k_up_enc, 0, 5, 0, drb_rx.data) == ip_packet
    if pcap:
        pcap.write(drb, DIR_UL, RNTI_C, C_RNTI, subframe=8)
        pcap.close()
    log(f"[7] Default bearer up (APN={b.apn}, IP={'.'.join(map(str, b.ip))}); "
        "ciphered user-plane packet delivered")
    result["bearer"] = True
    return result


def main():
    res = run(verbose=True,
              pcap_path=os.environ.get("LTEAX_ATTACH_PCAP"))
    print({"attach_complete": all(res.values()), **res})


if __name__ == "__main__":
    main()
