"""Cell search: coarse timing/CFO, PSS, SSS (36.211 §6.11).

(reference capability: ``liblte/src/liblte_phy.cc ::
liblte_phy_dl_find_coarse_timing_and_freq_offset``,
``liblte_phy_find_pss_and_fine_timing``, ``liblte_phy_find_sss`` — nested
C++ correlation loops over the sample buffer.)

Design: every correlator is expressed as either (a) a cumulative
-sum difference (CP autocorrelation — O(N) elementwise), or (b) one large
frequency-domain multiply (PSS matched filter bank: one FFT of the capture,
3 pointwise multiplies, one batched IFFT), or (c) a dense (62 x 168) matmul
(SSS hypothesis bank).  All batchable over a leading (carrier/chunk) axis.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from lteax.phy.config import PhyConfig
from lteax.phy import seq
from lteax.phy.grid import sync_sc

SC_SPACING = 15000.0


# ---------------------------------------------------------------------------
# Coarse timing + fractional CFO from CP autocorrelation
# ---------------------------------------------------------------------------

def cp_autocorrelation(x: jnp.ndarray, cfg: PhyConfig) -> jnp.ndarray:
    """Sliding CP correlation  corr[n] = sum_{i<cp} x[n+i] conj(x[n+i+N]).

    x (..., L) -> corr (..., L - n_fft - cp).  Computed with a cumsum
    difference: O(L) elementwise work.
    Uses the slot-tail CP length (144-class); the symbol-0 CP only adds
    margin.
    """
    n = cfg.n_fft
    cp = cfg.cp_lengths_slot[1]
    y = x[..., :-n] * jnp.conj(x[..., n:])
    c = jnp.cumsum(y, axis=-1)
    zero = jnp.zeros_like(c[..., :1])
    c = jnp.concatenate([zero, c], axis=-1)
    return c[..., cp:] - c[..., :-cp]


def coarse_timing_and_cfo(x: jnp.ndarray, cfg: PhyConfig):
    """Estimate symbol timing (mod one slot) and fractional CFO.

    Folds the CP correlation magnitude over slot periods to average across
    the capture, then reads the fractional CFO from the phase at the peak.
    Returns (timing_offset_in_slot, cfo_hz) — arrays broadcast over leading
    axes of x.
    """
    corr = cp_autocorrelation(x, cfg)
    slot = cfg.n_samps_slot
    n_slots = corr.shape[-1] // slot
    folded = corr[..., : n_slots * slot].reshape(*corr.shape[:-1], n_slots, slot)
    acc = jnp.sum(folded, axis=-2)
    mag = jnp.abs(acc)
    t0 = jnp.argmax(mag, axis=-1)
    peak = jnp.take_along_axis(acc, t0[..., None], axis=-1)[..., 0]
    cfo = -jnp.angle(peak) / (2 * jnp.pi) * SC_SPACING
    return t0, cfo


def apply_cfo(x: jnp.ndarray, cfo_hz, fs: float) -> jnp.ndarray:
    """Mix x by -cfo (correct the offset)."""
    n = jnp.arange(x.shape[-1])
    rot = jnp.exp(-2j * jnp.pi * jnp.asarray(cfo_hz)[..., None] * n / fs)
    return x * rot.astype(jnp.complex64)


# ---------------------------------------------------------------------------
# PSS matched filter bank
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def pss_time_filters(cfg: PhyConfig) -> np.ndarray:
    """(3, n_fft) complex64 time-domain PSS replicas (unit energy)."""
    filt = np.zeros((3, cfg.n_fft), dtype=np.complex64)
    bins = cfg.sc_to_fft_bin[sync_sc(cfg)]
    for nid2 in range(3):
        f = np.zeros(cfg.n_fft, dtype=np.complex64)
        f[bins] = seq.pss_sequence(nid2)
        t = np.fft.ifft(f) * np.sqrt(cfg.n_fft)
        filt[nid2] = (t / np.linalg.norm(t)).astype(np.complex64)
    return filt


_PSS_FFT_MAX = 1 << 15   # one-shot FFT cap; larger captures go overlap-save


def pss_correlate(x: jnp.ndarray, cfg: PhyConfig) -> jnp.ndarray:
    """Correlate x (..., L) with the 3 PSS replicas.

    Returns (..., 3, L) correlation magnitude² (peak index = PSS *start*
    sample).

    Short captures: one capture FFT + 3 pointwise multiplies + batched
    IFFT.  Long captures: overlap-save with fixed-size block FFTs, so the
    transform size stays bounded and same-size blocks share one FFT plan.
    """
    l = x.shape[-1]
    filt = pss_time_filters(cfg)
    nfft = int(2 ** np.ceil(np.log2(l + cfg.n_fft)))
    if nfft <= _PSS_FFT_MAX:
        xf = jnp.fft.fft(x, n=nfft, axis=-1)
        hf = jnp.fft.fft(jnp.asarray(np.conj(filt[:, ::-1])), n=nfft, axis=-1)
        cc = jnp.fft.ifft(xf[..., None, :] * hf, axis=-1)
        # full correlation: corr[n] = sum_k x[n+k] conj(h[k]) at lag n+Nf-1
        corr = cc[..., cfg.n_fft - 1: cfg.n_fft - 1 + l]
        return jnp.abs(corr) ** 2
    # ---- overlap-save: blocks of `step` new samples + (Nf-1) halo ----
    nb = _PSS_FFT_MAX
    nf = cfg.n_fft
    step = nb - nf            # valid outputs per block (uses nf-1 halo)
    n_blk = -(-l // step)
    pad = n_blk * step + nf - 1 - l
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    # block b covers samples [b*step, b*step + step + nf - 1)
    blocks = jnp.stack(
        [jax.lax.slice_in_dim(xp, b * step, b * step + step + nf - 1,
                              axis=-1) for b in range(n_blk)], axis=-2)
    xf = jnp.fft.fft(blocks, n=nb, axis=-1)          # (..., n_blk, nb)
    hf = np.fft.fft(np.conj(filt[:, ::-1]), n=nb, axis=-1).astype(np.complex64)
    cc = jnp.fft.ifft(xf[..., None, :, :] * jnp.asarray(hf)[:, None, :],
                      axis=-1)
    # valid region per block: lags nf-1 .. nf-1+step-1
    corr = cc[..., nf - 1: nf - 1 + step]            # (..., 3, n_blk, step)
    corr = corr.reshape(*corr.shape[:-2], n_blk * step)[..., :l]
    return jnp.abs(corr) ** 2


def find_pss(x: jnp.ndarray, cfg: PhyConfig, rel_threshold: float = 0.9):
    """Returns (n_id_2, pss_start_idx, peak_power) over the whole capture.

    Picks the strongest root, then the EARLIEST peak within
    ``rel_threshold`` of that root's maximum — periodic PSS repeats tie in
    magnitude, and locking early maximises the usable capture."""
    p = pss_correlate(x, cfg)                 # (..., 3, L)
    root_max = jnp.max(p, axis=-1)            # (..., 3)
    n_id_2 = jnp.argmax(root_max, axis=-1)
    pr = jnp.take_along_axis(p, n_id_2[..., None, None], axis=-2)[..., 0, :]
    peak = jnp.max(pr, axis=-1)
    near = pr >= rel_threshold * peak[..., None]
    idx = jnp.argmax(near, axis=-1)           # first True
    return n_id_2, idx, peak


# ---------------------------------------------------------------------------
# SSS detection (coherent, using the PSS symbol as channel reference)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _sss_banks(n_id_2: int) -> np.ndarray:
    """(2, 168, 62): subframe-0 and subframe-5 hypothesis banks."""
    return np.stack([seq.sss_bank(n_id_2, False), seq.sss_bank(n_id_2, True)])


def sss_detect(sss_re: jnp.ndarray, pss_re: jnp.ndarray, n_id_2: int):
    """Detect N_id_1 and frame half from extracted 62-RE symbols.

    sss_re, pss_re: (62,) frequency-domain REs of the SSS and PSS symbols.
    Channel is equalized coherently with the PSS (they are adjacent symbols).
    Returns (n_id_1, subframe5_bool, score).
    """
    h = pss_re * jnp.conj(jnp.asarray(seq.pss_sequence(n_id_2)))
    eq = sss_re * jnp.conj(h)                       # ∝ sss * |h|^2
    banks = jnp.asarray(_sss_banks(n_id_2))         # (2, 168, 62)
    scores = jnp.einsum("k,hnk->hn", jnp.real(eq), banks) \
        + 0.0  # imaginary part carries no SSS energy
    flat = scores.reshape(-1)
    am = jnp.argmax(flat)
    half = am // 168
    n_id_1 = am % 168
    return n_id_1, half.astype(bool), flat[am]
