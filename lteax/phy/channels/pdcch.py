"""PDCCH: control channel — CCE/REG multiplexing, interleaving, blind decode
(36.212 §5.3.3, 36.211 §6.8).

(reference capability: ``liblte/src/liblte_phy.cc ::
liblte_phy_pdcch_channel_encode`` / ``liblte_phy_pdcch_channel_decode`` with
serial blind search over candidates.)

Design: the REG quadruplet interleaver + cell-ID cyclic shift is
ONE precomputed permutation; blind decoding batches all search-space
candidates through a single vmapped Viterbi (the reference retries serially).
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from lteax.phy.config import PhyConfig
from lteax.phy.fec.crc import attach_crc, check_crc
from lteax.phy.fec.conv import conv_encode
from lteax.phy.fec.viterbi import viterbi_decode_tb_batch
from lteax.phy.fec.ratematch import (conv_rm_indices, rate_match, rate_unmatch,
                                     PERM_CONV, _subblock_col_read)
from lteax.phy.mod import modulate
from lteax.phy import seq
from lteax.phy.grid import pdcch_reg_list
from lteax.phy.channels.dci import dci_1a_size, dci_1a_unpack, Dci1A

REG_PER_CCE = 9
BITS_PER_REG = 8  # 4 REs x QPSK


def rnti_mask(rnti: int) -> np.ndarray:
    return np.array([(rnti >> (15 - i)) & 1 for i in range(16)], dtype=np.int32)


@lru_cache(maxsize=None)
def quad_permutation(m: int, n_cell_id: int) -> np.ndarray:
    """perm (m,): physical REG j carries logical quadruplet perm[j]
    (36.211 §6.8.5: §5.1.4.2.1 sub-block interleaver on quadruplets + cyclic
    shift by N_cell_ID)."""
    r = -(-m // 32)
    nd = r * 32 - m
    v = _subblock_col_read(m, PERM_CONV)
    order = np.asarray([x - nd for x in v if x >= nd], dtype=np.int64)
    assert len(order) == m
    j = np.arange(m)
    return order[(j + n_cell_id) % m].astype(np.int32)


def _c_init(n_cell_id: int, subframe: int) -> int:
    return subframe * 512 + n_cell_id


def n_cce(cfg: PhyConfig, n_cell_id: int, cfi: int, ng: float) -> int:
    """(reference capability: liblte_phy_get_n_cce)"""
    return len(pdcch_reg_list(cfg, n_cell_id, cfi, ng)) // REG_PER_CCE


def common_search_candidates(n_cces: int) -> list[tuple[int, int]]:
    """(cce_start, L) pairs of the common search space (36.213 §9.1.1)."""
    cands = []
    for l_agg, n_cand in ((4, 4), (8, 2)):
        for i in range(n_cand):
            start = i * l_agg
            if start + l_agg <= n_cces:
                cands.append((start, l_agg))
    return cands


def ue_search_y(rnti: int, subframe: int) -> int:
    """Y_k of the UE-specific search space hash (36.213 §9.1.1):
    Y_-1 = n_RNTI, Y_k = (A * Y_{k-1}) mod D with A=39827, D=65537."""
    y = rnti
    for _ in range(subframe + 1):
        y = (39827 * y) % 65537
    return y


def ue_search_candidates(n_cces: int, rnti: int, subframe: int
                         ) -> list[tuple[int, int]]:
    """(cce_start, L) pairs of the UE-specific search space for this RNTI
    and subframe (36.213 §9.1.1 Table 9.1.1-1: M(L) = 6/6/2/2 candidates at
    L = 1/2/4/8)."""
    y = ue_search_y(rnti, subframe)
    cands = []
    for l_agg, n_cand in ((1, 6), (2, 6), (4, 2), (8, 2)):
        n_l = n_cces // l_agg
        if n_l == 0:
            continue
        for m in range(n_cand):
            start = l_agg * ((y + m) % n_l)
            if start + l_agg <= n_cces:
                cands.append((start, l_agg))
    return cands


def search_candidates(n_cces: int, rnti: int, subframe: int | None
                     ) -> list[tuple[int, int]]:
    """Deduped candidate set: common space, plus the UE-specific space when
    ``subframe`` is given (C-RNTI monitoring per 36.213 §9.1.1)."""
    cands = common_search_candidates(n_cces)
    if subframe is not None:
        seen = set(cands)
        for c in ue_search_candidates(n_cces, rnti, subframe):
            if c not in seen:
                seen.add(c)
                cands.append(c)
    return cands


def pdcch_encode_logical(dcis: list[tuple[np.ndarray, int, int, int]],
                         cfg: PhyConfig, n_cell_id: int, cfi: int, ng: float,
                         subframe: int) -> np.ndarray:
    """Encode DCIs into LOGICAL (CCE-order) QPSK symbols, pre-interleaving.

    dcis: list of (dci_bits, rnti, cce_start, L_aggregation).
    Unused CCEs carry zero energy (<NIL>)."""
    m = len(pdcch_reg_list(cfg, n_cell_id, cfi, ng))
    n_bits_total = m * BITS_PER_REG
    bits = np.zeros(n_bits_total, dtype=np.int32)
    used = np.zeros(n_bits_total, dtype=bool)
    for dci_bits, rnti, cce_start, l_agg in dcis:
        b = np.asarray(attach_crc(jnp.asarray(dci_bits), "16",
                                  mask_bits=rnti_mask(rnti)))
        d = np.asarray(conv_encode(jnp.asarray(b)))
        e_len = l_agg * REG_PER_CCE * BITS_PER_REG
        e = np.asarray(rate_match(jnp.asarray(d),
                                  conv_rm_indices(d.shape[-1], e_len)))
        lo = cce_start * REG_PER_CCE * BITS_PER_REG
        bits[lo:lo + e_len] = e
        used[lo:lo + e_len] = True
    c = seq.gold_sequence_np(_c_init(n_cell_id, subframe), n_bits_total)
    scr = (bits + c) % 2
    sym = np.asarray(modulate(jnp.asarray(scr), "qpsk"))
    return np.where(used.reshape(-1, 2)[:, 0], sym, 0.0).astype(np.complex64)


def permute_to_phys(sym_logical: np.ndarray, cfg: PhyConfig, n_cell_id: int,
                    cfi: int, ng: float) -> np.ndarray:
    """Logical symbol sequence -> physical REG order (36.211 §6.8.5
    quadruplet interleave + cell-ID cyclic shift)."""
    m = len(pdcch_reg_list(cfg, n_cell_id, cfi, ng))
    perm = quad_permutation(m, n_cell_id)
    return sym_logical.reshape(m, 4)[perm].reshape(-1)


def unpermute_to_logical(vals_phys: jnp.ndarray, cfg: PhyConfig,
                         n_cell_id: int, cfi: int, ng: float) -> jnp.ndarray:
    """Physical REG order -> logical CCE order (values, not LLRs)."""
    m = len(pdcch_reg_list(cfg, n_cell_id, cfi, ng))
    perm = quad_permutation(m, n_cell_id)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(m, dtype=np.int32)
    return vals_phys.reshape(*vals_phys.shape[:-1], m, 4)[..., jnp.asarray(inv), :] \
        .reshape(*vals_phys.shape[:-1], -1)


def pdcch_encode(dcis: list[tuple[np.ndarray, int, int, int]],
                 cfg: PhyConfig, n_cell_id: int, cfi: int, ng: float,
                 subframe: int, n_ant: int = 1) -> jnp.ndarray:
    """Encode DCIs to per-port physical-REG-order symbols.

    Returns (n_ports, n_regs*4) complex (n_ports = 1 or 2; 2 uses SFBC)."""
    from lteax.phy.chest import precode_sfbc
    sym = pdcch_encode_logical(dcis, cfg, n_cell_id, cfi, ng, subframe)
    if n_ant == 1:
        ports = [sym]
    else:
        p0, p1 = precode_sfbc(jnp.asarray(sym))
        ports = [np.asarray(p0), np.asarray(p1)]
    phys = [permute_to_phys(np.asarray(p), cfg, n_cell_id, cfi, ng)
            for p in ports]
    return jnp.asarray(np.stack(phys))


def pdcch_descramble_logical(llrs_logical: jnp.ndarray, cfg: PhyConfig,
                             n_cell_id: int, cfi: int, ng: float,
                             subframe: int) -> jnp.ndarray:
    m = len(pdcch_reg_list(cfg, n_cell_id, cfi, ng))
    sgn = jnp.asarray((1.0 - 2.0 * seq.gold_sequence_np(
        _c_init(n_cell_id, subframe), m * BITS_PER_REG)).astype(np.float32))
    return llrs_logical * sgn


def pdcch_llrs_to_logical(llrs_phys: jnp.ndarray, cfg: PhyConfig,
                          n_cell_id: int, cfi: int, ng: float,
                          subframe: int) -> jnp.ndarray:
    """(m*8,) physical-REG-order LLRs -> descrambled logical-CCE-order LLRs.

    (SISO path: LLRs can be deinterleaved directly.  The SFBC path must
    deinterleave SYMBOLS first — use unpermute_to_logical + equalize +
    demod + pdcch_descramble_logical.)"""
    m = len(pdcch_reg_list(cfg, n_cell_id, cfi, ng))
    perm = quad_permutation(m, n_cell_id)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(m, dtype=np.int32)
    logical = llrs_phys.reshape(m, 2 * 4)[jnp.asarray(inv)].reshape(-1)
    return pdcch_descramble_logical(logical, cfg, n_cell_id, cfi, ng, subframe)


def _blind_decode(logical_llrs: jnp.ndarray, payload_size: int, rnti: int,
                  n_cces: int, unpack, subframe: int | None = None) -> list:
    """Generic blind decode: batched Viterbi over every candidate of the
    common search space (plus the UE-specific space when ``subframe`` is
    given), CRC16 with the RNTI mask, ``unpack(bits)`` to parse.

    All candidates — both spaces, every aggregation level — go through ONE
    vmapped Viterbi batch (the reference retries serially per candidate)."""
    d_len = payload_size + 16
    cands = search_candidates(n_cces, rnti, subframe)
    if not cands:
        return []
    stacks = []
    for start, l_agg in cands:
        e_len = l_agg * REG_PER_CCE * BITS_PER_REG
        lo = start * REG_PER_CCE * BITS_PER_REG
        e = logical_llrs[lo:lo + e_len]
        stacks.append(np.asarray(rate_unmatch(e, conv_rm_indices(d_len, e_len),
                                              d_len)))
    bits = np.asarray(viterbi_decode_tb_batch(jnp.asarray(np.stack(stacks)),
                                              d_len))
    out = []
    mask = rnti_mask(rnti)
    for (start, l_agg), b in zip(cands, bits):
        payload, ok = check_crc(jnp.asarray(b), "16", mask_bits=mask)
        if bool(ok):
            dci = unpack(np.asarray(payload))
            if dci is not None:
                out.append((dci, start, l_agg))
    return out


def pdcch_blind_decode_1a(logical_llrs: jnp.ndarray, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None) -> list[tuple[Dci1A, int, int]]:
    """Blind-decode DCI format 1A in the common search space.

    Returns list of (dci, cce_start, L) that passed CRC for ``rnti``."""
    return _blind_decode(logical_llrs, dci_1a_size(n_rb), rnti, n_cces,
                         lambda b: dci_1a_unpack(b, n_rb), subframe)


def pdcch_blind_decode_1c(logical_llrs: jnp.ndarray, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 1C (compact SI/paging/RA grants)."""
    from lteax.phy.channels.dci import dci_1c_size, dci_1c_unpack
    return _blind_decode(logical_llrs, dci_1c_size(n_rb), rnti, n_cces,
                         lambda b: dci_1c_unpack(b, n_rb), subframe)


def pdcch_blind_decode_1(logical_llrs: jnp.ndarray, n_rb: int, rnti: int,
                         n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 1 (type-0 RBG-bitmap grants)."""
    from lteax.phy.channels.dci import dci_1_size, dci_1_unpack
    return _blind_decode(logical_llrs, dci_1_size(n_rb), rnti, n_cces,
                         lambda b: dci_1_unpack(b, n_rb), subframe)


def pdcch_blind_decode_2a(logical_llrs: jnp.ndarray, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 2A (TM3 two-codeword grants)."""
    from lteax.phy.channels.dci import dci_2a_size, dci_2a_unpack
    return _blind_decode(logical_llrs, dci_2a_size(n_rb), rnti, n_cces,
                         lambda b: dci_2a_unpack(b, n_rb), subframe)


def pdcch_blind_decode_2(logical_llrs: jnp.ndarray, n_rb: int, rnti: int,
                         n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 2 (TM4 two-codeword grants)."""
    from lteax.phy.channels.dci import dci_2_size, dci_2_unpack
    return _blind_decode(logical_llrs, dci_2_size(n_rb), rnti, n_cces,
                         lambda b: dci_2_unpack(b, n_rb), subframe)


def pdcch_blind_decode_0(logical_llrs: jnp.ndarray, n_rb: int, rnti: int,
                         n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 0 (UL grants; same padded size as 1A)."""
    from lteax.phy.channels.dci import dci_1a_size, dci_0_unpack
    return _blind_decode(logical_llrs, dci_1a_size(n_rb), rnti, n_cces,
                         lambda b: dci_0_unpack(b, n_rb), subframe)


def pdcch_blind_decode_1b(logical_llrs: jnp.ndarray, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None,
                          n_ant: int = 2) -> list:
    """Blind-decode DCI format 1B (TM6 rank-1 closed-loop grants)."""
    from lteax.phy.channels.dci import dci_1b_size, dci_1b_unpack
    return _blind_decode(logical_llrs, dci_1b_size(n_rb, n_ant), rnti,
                         n_cces, lambda b: dci_1b_unpack(b, n_rb, n_ant),
                         subframe)


def pdcch_blind_decode_1d(logical_llrs: jnp.ndarray, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None,
                          n_ant: int = 2) -> list:
    """Blind-decode DCI format 1D (TM5 MU-MIMO grants)."""
    from lteax.phy.channels.dci import dci_1d_size, dci_1d_unpack
    return _blind_decode(logical_llrs, dci_1d_size(n_rb, n_ant), rnti,
                         n_cces, lambda b: dci_1d_unpack(b, n_rb, n_ant),
                         subframe)


def pdcch_blind_decode_3(logical_llrs: jnp.ndarray, n_rb: int, rnti: int,
                         n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 3 (2-bit group TPC on a TPC-RNTI)."""
    from lteax.phy.channels.dci import dci_1a_size, dci_3_unpack
    return _blind_decode(logical_llrs, dci_1a_size(n_rb), rnti, n_cces,
                         lambda b: dci_3_unpack(b, n_rb), subframe)


def pdcch_blind_decode_3a(logical_llrs: jnp.ndarray, n_rb: int, rnti: int,
                          n_cces: int, subframe: int | None = None) -> list:
    """Blind-decode DCI format 3A (1-bit group TPC on a TPC-RNTI)."""
    from lteax.phy.channels.dci import dci_1a_size, dci_3a_unpack
    return _blind_decode(logical_llrs, dci_1a_size(n_rb), rnti, n_cces,
                         lambda b: dci_3a_unpack(b, n_rb), subframe)
