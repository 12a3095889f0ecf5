"""PBCH: broadcast channel (36.212 §5.3.1, 36.211 §6.6).

(reference capability: ``liblte/src/liblte_phy.cc ::
liblte_phy_bch_channel_encode`` / ``liblte_phy_bch_channel_decode`` with
blind antenna detection via CRC mask.)

The 40 ms codeword (MIB 24 bits + masked CRC16 → TBCC → 1920 bits normal CP)
is spread over 4 frames.  The decoder sees one frame's quarter and blindly
resolves (quarter phase q, n_ant) — we batch all 12 hypotheses through ONE
vmapped Viterbi instead of the reference's serial retry loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lteax.phy.config import PhyConfig
from lteax.phy.fec.crc import attach_crc, check_crc
from lteax.phy.fec.conv import conv_encode
from lteax.phy.fec.viterbi import viterbi_decode_tb_batch
from lteax.phy.fec.ratematch import conv_rm_indices, rate_match, rate_unmatch
from lteax.phy.mod import modulate
from lteax.phy import seq
from lteax.phy.grid import pbch_flat_idx
from lteax.phy.chest import precode_sfbc

E_PBCH_NORM = 1920
E_PBCH_EXT = 1728


def e_pbch(extended_cp: bool = False) -> int:
    return E_PBCH_EXT if extended_cp else E_PBCH_NORM


ANT_MASKS = {
    1: np.zeros(16, dtype=np.int32),
    2: np.ones(16, dtype=np.int32),
    4: np.tile(np.array([0, 1], dtype=np.int32), 8),
}


def pbch_encode_40ms(mib_bits: jnp.ndarray, n_ant: int,
                     n_cell_id: int, extended_cp: bool = False) -> jnp.ndarray:
    """MIB (24,) -> (4, E/4) scrambled+rate-matched bit quarters (one per
    frame of the 40 ms TTI)."""
    e_len = e_pbch(extended_cp)
    b = attach_crc(mib_bits, "16", mask_bits=ANT_MASKS[n_ant])
    d = conv_encode(b)                                  # (3, 40)
    idx = conv_rm_indices(40, e_len)
    e = rate_match(d, idx)
    c = seq.gold_sequence(jnp.int32(n_cell_id), e_len)
    e = (e + c) % 2
    return e.reshape(4, e_len // 4)


def pbch_quarter_to_grid(quarter_bits: jnp.ndarray, cfg: PhyConfig,
                         n_cell_id: int, n_ant: int) -> dict[int, jnp.ndarray]:
    """One frame's quarter bits -> per-port RE values at pbch_flat_idx.

    Returns {port: (n_re,) complex}: 1 port direct, 2-port SFBC,
    4-port SFBC+FSTD."""
    from lteax.phy.chest import precode_sfbc_fstd
    sym = modulate(quarter_bits, "qpsk")                # (240,)
    if n_ant == 1:
        return {0: sym}
    if n_ant == 2:
        p0, p1 = precode_sfbc(sym)
        return {0: p0, 1: p1}
    p0, p1, p2, p3 = precode_sfbc_fstd(sym)
    return {0: p0, 1: p1, 2: p2, 3: p3}


def pbch_blind_decode(llrs_by_ant: dict[int, jnp.ndarray], n_cell_id: int,
                      extended_cp: bool = False):
    """Resolve (n_ant, quarter) from one frame's PBCH LLRs.

    llrs_by_ant: {n_ant_hypothesis: (E/4,) RAW llrs in RE order}.
    Descrambling needs the quarter phase, handled inside.

    Returns (mib_bits (24,), n_ant, sfn_mod4, ok) as numpy/python values.
    """
    e_len = e_pbch(extended_cp)
    qlen = e_len // 4
    c = np.asarray(seq.gold_sequence_np(n_cell_id, e_len))
    sgn = (1.0 - 2.0 * c).astype(np.float32)
    idx = conv_rm_indices(40, e_len)
    cands = []
    metas = []
    for n_ant, llr in llrs_by_ant.items():
        llr = np.asarray(llr)
        for q in range(4):
            buf = np.zeros(e_len, dtype=np.float32)
            buf[q * qlen:(q + 1) * qlen] = llr
            buf *= sgn
            d_llr = np.asarray(rate_unmatch(jnp.asarray(buf), idx, 40))
            cands.append(d_llr)
            metas.append((n_ant, q))
    stack = jnp.asarray(np.stack(cands))                # (n_hyp, 3, 40)
    bits = np.asarray(viterbi_decode_tb_batch(stack, 40))
    for (n_ant, q), b in zip(metas, bits):
        payload, ok = check_crc(jnp.asarray(b), "16",
                                mask_bits=ANT_MASKS[n_ant])
        if bool(ok):
            return np.asarray(payload), n_ant, q, True
    return None, 0, 0, False
