"""Rate matching for turbo and convolutional codes (36.212 §5.1.4).

(reference capability: ``liblte/src/liblte_phy.cc :: rate_match_turbo``,
``rate_unmatch_turbo``, ``rate_match_conv``, ``rate_unmatch_conv`` — nested
C++ loops building the sub-block interleaver and walking the circular buffer
bit by bit.)

Design: the whole pipeline (dummy-padding, sub-block interleaving,
circular-buffer collection, NULL skipping, redundancy-version offset) is a
fixed permutation for a given (D, E, rv).  We precompute ONE index vector on
host:  ``e = d_flat[idx]`` for matching, and rate *de*-matching with soft
combining of repeated bits is one ``scatter-add``:
``llr_d = zeros(3D).at[idx].add(e_llrs)``.  No device control flow at all.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

# Table 5.1.4-1 (turbo) inter-column permutation, 32 columns
PERM_TURBO = np.array(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64)
# Table 5.1.4-2 (convolutional)
PERM_CONV = np.array(
    [1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
     0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30],
    dtype=np.int64)

_C = 32  # sub-block interleaver columns


def _subblock_col_read(d_len: int, perm: np.ndarray) -> np.ndarray:
    """Positions into the ND-padded stream for column-wise readout.

    y = [NULL]*ND + d written row-wise into (R, 32); columns permuted by
    ``perm``; read column-wise.  Returns (R*32,) indices into y."""
    r = -(-d_len // _C)
    cols = np.repeat(perm, r)          # column index per output position
    rows = np.tile(np.arange(r), _C)
    return rows * _C + cols


@lru_cache(maxsize=None)
def turbo_rm_indices(d_len: int, e_len: int, rv: int,
                     n_cb: int | None = None) -> np.ndarray:
    """Index vector idx (E,) into flat d (3*D) implementing 36.212 §5.1.4.1.

    d layout: [d0 | d1 | d2], each D = K+4 bits.
    """
    D = d_len
    R = -(-D // _C)
    Kp = R * _C
    ND = Kp - D
    v01 = _subblock_col_read(D, PERM_TURBO)                    # streams 0, 1
    k_arr = np.arange(Kp, dtype=np.int64)
    v2 = (PERM_TURBO[k_arr // R] + _C * (k_arr % R) + 1) % Kp  # stream 2
    # w -> flat-d map (−1 == NULL)
    w2d = np.full(3 * Kp, -1, dtype=np.int64)
    w2d[:Kp] = np.where(v01 >= ND, v01 - ND, -1)
    w2d[Kp::2] = np.where(v01 >= ND, D + v01 - ND, -1)
    w2d[Kp + 1::2] = np.where(v2 >= ND, 2 * D + v2 - ND, -1)
    Kw = 3 * Kp
    ncb = Kw if n_cb is None else min(n_cb, Kw)
    k0 = R * (2 * (-(-ncb // (8 * R))) * rv + 2)
    order = (k0 + np.arange(ncb)) % ncb
    valid = order[w2d[order] >= 0]
    idx = w2d[valid[np.arange(e_len) % len(valid)]]
    return idx.astype(np.int32)


@lru_cache(maxsize=None)
def conv_rm_indices(d_len: int, e_len: int) -> np.ndarray:
    """Index vector idx (E,) into flat d (3*D) per 36.212 §5.1.4.2."""
    D = d_len
    R = -(-D // _C)
    Kp = R * _C
    ND = Kp - D
    v = _subblock_col_read(D, PERM_CONV)
    w2d = np.concatenate([
        np.where(v >= ND, s * D + v - ND, -1) for s in range(3)
    ])
    order = np.arange(3 * Kp)
    valid = order[w2d[order] >= 0]
    idx = w2d[valid[np.arange(e_len) % len(valid)]]
    return idx.astype(np.int32)


# ---------------------------------------------------------------------------
# Device ops (jittable, batched over leading axes)
# ---------------------------------------------------------------------------

def rate_match(d: jnp.ndarray, idx: np.ndarray) -> jnp.ndarray:
    """d (..., 3, D) encoded streams -> e (..., E) transmitted bits."""
    flat = d.reshape(*d.shape[:-2], -1)
    return flat[..., jnp.asarray(idx)]


def rate_unmatch(e_llrs: jnp.ndarray, idx: np.ndarray, d_len: int) -> jnp.ndarray:
    """e_llrs (..., E) -> d LLRs (..., 3, D); repeats soft-combine via add."""
    out = jnp.zeros((*e_llrs.shape[:-1], 3 * d_len), dtype=e_llrs.dtype)
    out = out.at[..., jnp.asarray(idx)].add(e_llrs)
    return out.reshape(*e_llrs.shape[:-1], 3, d_len)


def unmatch_inv_cycles(idx: np.ndarray, d_total: int) -> np.ndarray:
    """Occurrence-rank inverse maps turning a soft de-match scatter-add into
    a SUM OF GATHERS (no scatter).

    Returns inv (n_cycles, d_total) int32 with inv[k, p] = the e-position of
    the (k+1)-th transmission of d-flat bit p, or ``len(idx)`` (a zero
    sentinel — gather from an e vector extended with one trailing 0).
    n_cycles = max repetition count (1 when injective, ceil(E/L) when the
    circular buffer wraps).  ``sum_k e_ext[inv[k]]`` == scatter-add result
    up to float summation order.
    """
    idx = np.asarray(idx, dtype=np.int64)
    e_len = len(idx)
    order = np.argsort(idx, kind="stable")
    si = idx[order]
    first = np.r_[True, si[1:] != si[:-1]]
    grp_start = np.maximum.accumulate(np.where(first, np.arange(e_len), 0))
    rank = np.arange(e_len) - grp_start
    n_cycles = int(rank.max()) + 1 if e_len else 1
    inv = np.full((n_cycles, d_total), e_len, dtype=np.int32)
    inv[rank, si] = order.astype(np.int32)
    return inv


def rate_unmatch_gather(e_llrs: jnp.ndarray, inv: np.ndarray,
                        d_len: int) -> jnp.ndarray:
    """Gather-based :func:`rate_unmatch` using :func:`unmatch_inv_cycles`
    maps (precompute once per (D, E, rv)).  e_llrs (..., E) -> (..., 3, D)."""
    ext = jnp.concatenate(
        [e_llrs, jnp.zeros((*e_llrs.shape[:-1], 1), e_llrs.dtype)], axis=-1)
    out = ext[..., jnp.asarray(inv[0])]
    for k in range(1, inv.shape[0]):
        out = out + ext[..., jnp.asarray(inv[k])]
    return out.reshape(*e_llrs.shape[:-1], 3, d_len)


# ---------------------------------------------------------------------------
# Structured (gather-free) rate de-matching
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _dematch_plan(d_len: int, e_len: int, rv: int, n_cb: int | None = None):
    """Slice/concat plan equivalent to the injective rate-unmatch gather.

    The sub-block interleaver is column-structured: viewed in the
    column-major (transposed) d domain, the e->d permutation decomposes into
    maximal runs of constant d-stride 1 and constant (small) e-stride —
    each a strided slice of the e stream.  The d-transposed buffer is then
    a pure concat of e-slices and zero gaps; one reshape/transpose recovers
    d.  Slices/concats are layout ops; no gather.

    Returns (runs, total_q, R, ND) with runs = [(q_start, e_start, e_stride,
    length)] in ascending q, or None when the mapping is not injective
    (repetition soft-combining keeps the scatter-add path).
    """
    idx = turbo_rm_indices(d_len, e_len, rv, n_cb)
    if len(np.unique(idx)) != len(idx):
        return None
    D = d_len
    R = -(-D // _C)
    Kp = R * _C
    ND = Kp - D
    s = idx // D
    i = idx % D
    y = i + ND
    q = s * Kp + (y % _C) * R + (y // _C)       # d-transposed position
    order = np.argsort(q)
    qs, es = q[order], np.arange(e_len, dtype=np.int64)[order]
    runs = []
    t = 0
    while t < len(qs):
        q0, e0 = int(qs[t]), int(es[t])
        n = 1
        step = None
        while t + n < len(qs) and qs[t + n] == q0 + n:
            st = int(es[t + n] - es[t + n - 1])
            if st <= 0 or st > 8 or (step is not None and st != step):
                break
            step = st
            n += 1
        runs.append((q0, e0, step or 1, n))
        t += n
    return tuple(runs), 3 * Kp, R, ND


def make_rate_unmatch_structured(d_len: int, e_len: int, rv: int = 0,
                                 n_cb: int | None = None):
    """-> (fn(e (..., E) -> d (..., 3, D)), n_runs), or None if the mapping
    is non-injective (HARQ repetition — use ``rate_unmatch``).

    Build-time verified against the gather path; batched over leading axes.
    """
    import jax
    plan = _dematch_plan(d_len, e_len, rv, n_cb)
    if plan is None:
        return None
    runs, total_q, R, ND = plan
    D = d_len
    # build-time verification against the gather semantics
    idx = turbo_rm_indices(d_len, e_len, rv, n_cb)
    probe = np.arange(1, e_len + 1, dtype=np.int64)
    dt = np.zeros(total_q, dtype=np.int64)
    for q0, e0, st, n in runs:
        dt[q0:q0 + n] = probe[e0:e0 + st * (n - 1) + 1:st]
    d_chk = dt.reshape(3, _C, R).transpose(0, 2, 1).reshape(3, _C * R)[:, ND:]
    ref = np.zeros(3 * D, dtype=np.int64)
    ref[idx] = probe
    assert np.array_equal(d_chk.reshape(-1), ref), "structured plan != gather"

    def fn(e):
        import jax.numpy as jnp
        lead = e.shape[:-1]
        pieces = []
        pos = 0
        for q0, e0, st, n in runs:
            if q0 > pos:
                pieces.append(jnp.zeros((*lead, q0 - pos), e.dtype))
            seg = jax.lax.slice_in_dim(e, e0, e0 + st * (n - 1) + 1,
                                       stride=st, axis=-1)
            pieces.append(seg)
            pos = q0 + n
        if pos < total_q:
            pieces.append(jnp.zeros((*lead, total_q - pos), e.dtype))
        dt = jnp.concatenate(pieces, axis=-1)
        d = dt.reshape(*lead, 3, _C, R).swapaxes(-1, -2)
        return d.reshape(*lead, 3, _C * R)[..., ND:]

    return fn, len(runs)
