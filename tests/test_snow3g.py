"""SNOW 3G / 128-EEA1 / 128-EIA1.

Provenance: the 128-EEA1 test checks the full 256-bit ciphertext of
33.401 C.1 test set 1 — an externally published vector (recalled, like the
security.py Milenage/EIA2 vectors; the spec documents are not present in
this environment).  A full 32-byte match pins the entire SNOW 3G core
(S-boxes, LFSR feedback, FSM, init schedule, IV keying).  The EIA1 MAC
construction follows the UIA2 spec; no published MAC vector was available
to pin the final fold, so its tests are structural (documented [U] in
KNOWN_ISSUES.md).
"""

import pytest

from lteax.stack import snow3g
from lteax.stack import security


def test_sbox_generation_anchors():
    """Both S-boxes are GENERATED from algebraic definitions; anchor the
    first entries against the published tables."""
    assert snow3g.SR[:8] == [0x63, 0x7C, 0x77, 0x7B, 0xF2, 0x6B, 0x6F, 0xC5]
    assert snow3g.SQ[:8] == [0x25, 0x24, 0x73, 0x67, 0xD7, 0xAE, 0x5C, 0x30]
    assert sorted(snow3g.SR) == list(range(256))     # permutations
    assert sorted(snow3g.SQ) == list(range(256))


def test_eea1_33401_c1_set1():
    """33.401 C.1 128-EEA1 test set 1: full ciphertext, 253 bits."""
    key = bytes.fromhex("d3c5d592327fb11c4035c6680af8c6d1")
    pt = bytes.fromhex("981ba6824c1bfb1ab485472029b71d80"
                       "8ce33e2cc3c0b5fc1f3de8a6dc66b1f0")
    ct = snow3g.eea1(key, 0x398A59B4, 0x15, 1, pt, data_bits=253)
    assert ct == bytes.fromhex("5d5bfe75eb04f68ce0a12377ea00b37d"
                               "47c6a0ba06309155086a859c4341b378")


def test_eea1_involution_and_sensitivity():
    key = bytes(range(16))
    data = bytes(range(64))
    c = snow3g.eea1(key, 7, 3, 1, data)
    assert c != data
    assert snow3g.eea1(key, 7, 3, 1, c) == data
    assert snow3g.eea1(key, 8, 3, 1, c) != data          # count
    assert snow3g.eea1(key, 7, 4, 1, c) != data          # bearer
    assert snow3g.eea1(key, 7, 3, 0, c) != data          # direction


def test_eia1_structural():
    key = bytes.fromhex("2bd6459f82c5b300952c49104881ff48")
    msg = bytes.fromhex("3332346263393840")
    mac = snow3g.eia1(key, 0x38A6F056, 0x18, 0, msg, data_bits=58)
    assert len(mac) == 4
    # deterministic
    assert mac == snow3g.eia1(key, 0x38A6F056, 0x18, 0, msg, data_bits=58)
    # any input change moves the MAC
    assert mac != snow3g.eia1(key, 0x38A6F057, 0x18, 0, msg, data_bits=58)
    assert mac != snow3g.eia1(key, 0x38A6F056, 0x19, 0, msg, data_bits=58)
    assert mac != snow3g.eia1(key, 0x38A6F056, 0x18, 1, msg, data_bits=58)
    flipped = bytes([msg[0] ^ 0x80]) + msg[1:]
    assert mac != snow3g.eia1(key, 0x38A6F056, 0x18, 0, flipped,
                              data_bits=58)
    # bits beyond LENGTH must not affect the MAC
    assert mac == snow3g.eia1(key, 0x38A6F056, 0x18, 0,
                              msg[:-1] + bytes([msg[-1] ^ 0x3F]),
                              data_bits=58)


def test_eia1_multiblock_lengths():
    key = bytes(range(16))
    for n in (0, 1, 8, 9, 64, 65, 200):
        data = bytes(range(256))[:n]
        mac = snow3g.eia1(key, 1, 2, 0, data)
        assert len(mac) == 4
        if n:
            bad = bytes([data[0] ^ 1]) + data[1:]
            assert mac != snow3g.eia1(key, 1, 2, 0, bad)


def test_security_dispatch():
    key = bytes(range(16))
    data = b"dispatch-test-payload"
    assert security.eea(0, key, 1, 2, 1, data) == data            # EEA0
    e1 = security.eea(1, key, 1, 2, 1, data)
    e2 = security.eea(2, key, 1, 2, 1, data)
    assert e1 == snow3g.eea1(key, 1, 2, 1, data) and e1 != e2
    assert security.eea(1, key, 1, 2, 1, e1) == data
    m1 = security.eia(1, key, 1, 2, 1, data)
    m2 = security.eia(2, key, 1, 2, 1, data)
    assert m1 == snow3g.eia1(key, 1, 2, 1, data) and m1 != m2
    with pytest.raises(ValueError):
        security.eea(3, key, 1, 2, 1, data)


def test_pdcp_entity_snow3g_algs():
    """PDCP SRB round-trip under EEA1/EIA1 (alg id 1)."""
    from lteax.stack.pdcp import PdcpEntity
    ke, ki = bytes(range(16)), bytes(range(16, 32))
    tx = PdcpEntity(srb=True, rb_id=1, direction_tx=1, k_enc=ke, k_int=ki,
                    enc_alg=1, int_alg=1)
    rx = PdcpEntity(srb=True, rb_id=1, direction_tx=0, k_enc=ke, k_int=ki,
                    enc_alg=1, int_alg=1)
    for i in range(40):                                  # crosses SN wrap
        pdu = tx.encode(b"msg%d" % i)
        assert rx.decode(pdu) == b"msg%d" % i
    # integrity failure detected
    pdu = bytearray(tx.encode(b"tamper"))
    pdu[-1] ^= 1
    assert rx.decode(bytes(pdu)) is None
