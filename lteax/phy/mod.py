"""Modulation mapping and soft demapping (36.211 §7.1).

(reference capability: ``liblte/src/liblte_phy.cc :: modulation_mapper``,
``modulation_demapper`` / ``get_soft_decision``.)

Design: the mapper packs bit groups into symbol indices and does a single
constellation-table gather; the demapper computes exact max-log LLRs via
per-bit subset minima over the (<=64-point) constellation — elementwise
distances and reductions that XLA fuses, batched over symbols.  LLR
convention: L = log P(0)/P(1).
"""

from __future__ import annotations

import functools
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

BITS_PER_SYM = {"bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6}


@lru_cache(maxsize=None)
def constellation(scheme: str) -> np.ndarray:
    """(2**m,) complex64 table indexed by the bit-group value (b0 = MSB).

    Exact 36.211 §7.1 mappings:
      BPSK : x = (1-2b0)(1+j)/sqrt(2)
      QPSK : x = [(1-2b0) + j(1-2b1)]/sqrt(2)
      16QAM: I = (1-2b0)[2-(1-2b2)]/sqrt(10),  Q same with b1, b3
      64QAM: I = (1-2b0)[4-(1-2b2)(2-(1-2b4))]/sqrt(42), Q with b1, b3, b5
    """
    m = BITS_PER_SYM[scheme]
    pts = np.zeros(2 ** m, dtype=np.complex64)
    for v in range(2 ** m):
        b = [(v >> (m - 1 - i)) & 1 for i in range(m)]
        if scheme == "bpsk":
            i_ = q_ = (1 - 2 * b[0]) / np.sqrt(2)
        elif scheme == "qpsk":
            i_ = (1 - 2 * b[0]) / np.sqrt(2)
            q_ = (1 - 2 * b[1]) / np.sqrt(2)
        elif scheme == "16qam":
            i_ = (1 - 2 * b[0]) * (2 - (1 - 2 * b[2])) / np.sqrt(10)
            q_ = (1 - 2 * b[1]) * (2 - (1 - 2 * b[3])) / np.sqrt(10)
        else:  # 64qam
            i_ = (1 - 2 * b[0]) * (4 - (1 - 2 * b[2]) * (2 - (1 - 2 * b[4]))) / np.sqrt(42)
            q_ = (1 - 2 * b[1]) * (4 - (1 - 2 * b[3]) * (2 - (1 - 2 * b[5]))) / np.sqrt(42)
        pts[v] = i_ + 1j * q_
    return pts


@lru_cache(maxsize=None)
def _bit_masks(scheme: str) -> np.ndarray:
    """(m, 2**m) float: +1 where constellation point has bit=0, -inf-select."""
    m = BITS_PER_SYM[scheme]
    v = np.arange(2 ** m)
    return np.stack([((v >> (m - 1 - i)) & 1) for i in range(m)]).astype(np.bool_)


def modulate_arith(bits: jnp.ndarray, scheme: str) -> jnp.ndarray:
    """bits (..., N*m) -> symbols (..., N) complex64, PURE-ELEMENTWISE.

    Same mapping as :func:`modulate`, but the 36.211 §7.1 Gray formulas are
    evaluated arithmetically instead of via a constellation-table gather,
    so the SIC re-modulation is one elementwise fusion."""
    m = BITS_PER_SYM[scheme]
    g = bits.reshape(*bits.shape[:-1], -1, m).astype(jnp.float32)
    s = 1.0 - 2.0 * g                                 # (+1 for bit 0)
    if scheme == "bpsk":
        v = s[..., 0] / np.sqrt(2)
        return (v + 1j * v).astype(jnp.complex64)
    if scheme == "qpsk":
        return ((s[..., 0] + 1j * s[..., 1]) / np.sqrt(2)
                ).astype(jnp.complex64)
    if scheme == "16qam":
        i_ = s[..., 0] * (2.0 - s[..., 2]) / np.sqrt(10)
        q_ = s[..., 1] * (2.0 - s[..., 3]) / np.sqrt(10)
        return (i_ + 1j * q_).astype(jnp.complex64)
    i_ = s[..., 0] * (4.0 - s[..., 2] * (2.0 - s[..., 4])) / np.sqrt(42)
    q_ = s[..., 1] * (4.0 - s[..., 3] * (2.0 - s[..., 5])) / np.sqrt(42)
    return (i_ + 1j * q_).astype(jnp.complex64)


def modulate(bits: jnp.ndarray, scheme: str) -> jnp.ndarray:
    """bits (..., N*m) -> symbols (..., N) complex64."""
    m = BITS_PER_SYM[scheme]
    table = jnp.asarray(constellation(scheme))
    groups = bits.reshape(*bits.shape[:-1], -1, m).astype(jnp.int32)
    weights = jnp.asarray([1 << (m - 1 - i) for i in range(m)], dtype=jnp.int32)
    idx = groups @ weights
    return table[idx]


@lru_cache(maxsize=None)
def _pam_axis(scheme: str) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis PAM decomposition of a Gray square QAM constellation.

    Returns (levels (L,) float32, bit_is_one (m/2, L) bool) where the
    per-axis bit group is (b0, b2, b4)|I / (b1, b3, b5)|Q of 36.211 §7.1 —
    both axes use the same formula, so one table serves I and Q.
    """
    ma = BITS_PER_SYM[scheme] // 2
    lv = np.zeros(2 ** ma, dtype=np.float32)
    for v in range(2 ** ma):
        b = [(v >> (ma - 1 - i)) & 1 for i in range(ma)]
        if scheme == "qpsk":
            lv[v] = (1 - 2 * b[0]) / np.sqrt(2)
        elif scheme == "16qam":
            lv[v] = (1 - 2 * b[0]) * (2 - (1 - 2 * b[1])) / np.sqrt(10)
        else:  # 64qam
            lv[v] = (1 - 2 * b[0]) * (4 - (1 - 2 * b[1]) * (2 - (1 - 2 * b[2]))) / np.sqrt(42)
    v = np.arange(2 ** ma)
    bit1 = np.stack([((v >> (ma - 1 - i)) & 1) for i in range(ma)]).astype(np.bool_)
    return lv, bit1


def _subset_min_llr(y: jnp.ndarray, table: jnp.ndarray,
                    bit_is_one: jnp.ndarray) -> jnp.ndarray:
    """min_{bit=1} d2 - min_{bit=0} d2 over the last table axis.

    y (..., N) real or complex; table (M,); bit_is_one (m, M).
    Returns (..., N, m)."""
    if jnp.iscomplexobj(y):
        d2 = jnp.abs(y[..., None] - table) ** 2              # (..., N, M)
    else:
        d2 = (y[..., None] - table) ** 2
    big = jnp.float32(1e30)
    d2e = d2[..., None, :]                                   # (..., N, 1, M)
    d0 = jnp.min(jnp.where(bit_is_one, big, d2e), axis=-1)   # (..., N, m)
    d1 = jnp.min(jnp.where(bit_is_one, d2e, big), axis=-1)
    return d1 - d0


def demodulate_maxlog(symbols: jnp.ndarray, scheme: str,
                      noise_var=None) -> jnp.ndarray:
    """Exact max-log LLRs.  symbols (..., N) -> llrs (..., N*m) float32.

    L_i = (min_{s: bit_i(s)=1} |y-s|^2 - min_{s: bit_i(s)=0} |y-s|^2) / nv
    (positive ⇒ bit 0 more likely).  ``noise_var`` may be a scalar or
    per-symbol array (post-equalization effective noise); defaults to 1.

    For the Gray square QAM schemes the 2D subset minimum factorizes per
    axis — an I-axis bit constrains only Re(s), so the free min over Im(s)
    is common to both subsets and cancels in the difference.  The demap is
    therefore an exact L-level PAM subset-min per axis (8 real distances
    for 64QAM instead of 64 complex ones); BPSK couples the axes and keeps
    the generic path.
    """
    if scheme in ("qpsk", "16qam", "64qam"):
        pam, bit1 = _pam_axis(scheme)
        table, mask = jnp.asarray(pam), jnp.asarray(bit1)
        llr_i = _subset_min_llr(jnp.real(symbols), table, mask)  # (..., N, ma)
        llr_q = _subset_min_llr(jnp.imag(symbols), table, mask)
        # bit order per symbol is (b0|I, b1|Q, b2|I, b3|Q, ...)
        llr = jnp.stack([llr_i, llr_q], axis=-1).reshape(
            *symbols.shape[:-1], symbols.shape[-1], -1)
    else:
        table = jnp.asarray(constellation(scheme))
        mask = jnp.asarray(_bit_masks(scheme))
        llr = _subset_min_llr(symbols, table, mask)
    if noise_var is not None:
        llr = llr / jnp.asarray(noise_var)[..., None]
    return llr.reshape(*symbols.shape[:-1], -1)


def demap_planar(xr, xi, inv_nv, sgn_planar, scheme: str,
                 out_dtype=jnp.float32):
    """Max-log demap + LLR scaling + descramble with PLANAR output.

    xr, xi, inv_nv: (B, N) equalized symbol I/Q and 1/effective noise (any
    float dtype; the arithmetic runs in f32); sgn_planar: (m, Np) f32
    descrambling signs in planar layout (:func:`planar_sgn_np`), Np >= N.
    Returns (B, m, Np) LLRs: plane j holds bit j of every symbol, so the
    rate de-matcher absorbs the bit interleave by remapping its gather
    indices.  Columns past N read zero inputs and emit exact 0.0 (the
    pipelines point untransmitted positions at such a column).

    Same per-axis PAM subset-min as :func:`demodulate_maxlog` (QPSK, 16QAM
    and 64QAM), multiplied by ``inv_nv`` instead of divided by the noise."""
    assert scheme in ("qpsk", "16qam", "64qam"), scheme
    pam, bit1 = _pam_axis(scheme)
    ma = BITS_PER_SYM[scheme] // 2
    npad = sgn_planar.shape[1]

    def pad(x):
        x = x.astype(jnp.float32)
        return jnp.pad(x, ((0, 0), (0, npad - x.shape[1])))

    scale = pad(inv_nv)
    planes = [None] * (2 * ma)
    for axis, y in ((0, pad(xr)), (1, pad(xi))):
        d = [(y - float(s)) * (y - float(s)) for s in pam]
        for j in range(ma):
            d0 = functools.reduce(jnp.minimum,
                                  [d[i] for i in range(len(pam)) if not bit1[j, i]])
            d1 = functools.reduce(jnp.minimum,
                                  [d[i] for i in range(len(pam)) if bit1[j, i]])
            # bit order per symbol: (b0|I, b1|Q, b2|I, b3|Q, ...)
            planes[2 * j + axis] = (d1 - d0) * scale
    return (jnp.stack(planes, axis=1) * sgn_planar).astype(out_dtype)


# bounded: c_init varies per (rnti, subframe, codeword) — a long-running
# service building decoders for many RNTIs must not grow host memory
# without bound (each entry is an (m, npad) f32 array)
@lru_cache(maxsize=64)
def planar_sgn_np(c_init: int, g: int, m: int, npad: int) -> np.ndarray:
    """(m, npad) f32 scrambling signs in planar layout: plane j, column s
    holds the sign of interleaved bit s*m + j."""
    from lteax.phy.seq import scrambling_symbols_np
    sgn = scrambling_symbols_np(c_init, g)            # (G,)
    n = g // m
    out = np.ones((m, npad), dtype=np.float32)
    out[:, :n] = sgn.reshape(n, m).T
    return out
