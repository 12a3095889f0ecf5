"""Resource-element (de)mapping index tables (36.211 §6).

(reference capability: the RE-mapping index arithmetic scattered through
``liblte/src/liblte_phy.cc`` — ``liblte_phy_map_crs``, the PBCH/PCFICH/
PDCCH/PDSCH mapping loops inside each ``*_channel_encode``/``_decode``.)

Design: every channel's RE set is a *static* function of
(PhyConfig, N_cell_ID, CFI, subframe, allocation), so all positions are
precomputed host-side (numpy, cached) as flat indices ``sym * n_sc + k``
into the flattened subframe grid.  Device code is pure gather/scatter with
fixed shapes — zero control flow under jit.

All mappings are frequency-first (increasing k, then increasing l), per the
36.211 mapping clauses.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from lteax.phy.config import PhyConfig

# ---------------------------------------------------------------------------
# CRS (36.211 §6.10.1.2)
# ---------------------------------------------------------------------------

def _crs_v(port: int, l: int, ns: int) -> int:
    if port == 0:
        return 0 if l == 0 else 3
    if port == 1:
        return 3 if l == 0 else 0
    if port == 2:
        return 3 * (ns % 2)
    return 3 + 3 * (ns % 2)


def crs_symbols(port: int, cfg: PhyConfig) -> tuple[int, ...]:
    """Subframe symbol indices carrying CRS for this port (normal CP)."""
    nss = cfg.n_sym_slot
    if port < 2:
        last = 4 if not cfg.extended_cp else 3
        return (0, last, nss, nss + last)
    return (1, nss + 1)


@lru_cache(maxsize=None)
def crs_flat_idx(cfg: PhyConfig, n_cell_id: int, port: int) -> np.ndarray:
    """(n_pilots,) flat indices of CRS REs of ``port`` in one subframe,
    ordered symbol-major then k-ascending."""
    vs = n_cell_id % 6
    out = []
    nss = cfg.n_sym_slot
    for sym in crs_symbols(port, cfg):
        ns_off = sym // nss          # 0 or 1 within the subframe
        l = sym % nss
        v = _crs_v(port, l, ns_off)  # ns parity == slot index parity here
        k = 6 * np.arange(2 * cfg.n_rb_dl) + (v + vs) % 6
        out.append(sym * cfg.n_sc + k)
    return np.concatenate(out).astype(np.int32)


@lru_cache(maxsize=None)
def crs_reserved_mask(cfg: PhyConfig, n_cell_id: int) -> np.ndarray:
    """(n_sym, n_sc) bool — True where ANY configured CRS port maps a pilot
    (those REs are unavailable to other channels)."""
    mask = np.zeros(cfg.n_sym_subframe * cfg.n_sc, dtype=bool)
    for p in range(cfg.n_ant):
        mask[crs_flat_idx(cfg, n_cell_id, p)] = True
    return mask.reshape(cfg.n_sym_subframe, cfg.n_sc)


# ---------------------------------------------------------------------------
# PSS / SSS (36.211 §6.11) — FDD: PSS = last symbol of slots 0/10,
# SSS = previous symbol; subframes 0 and 5.  Central 62 subcarriers.
# ---------------------------------------------------------------------------

def pss_sym(cfg: PhyConfig) -> int:
    return cfg.n_sym_slot - 1


def sss_sym(cfg: PhyConfig) -> int:
    return cfg.n_sym_slot - 2


@lru_cache(maxsize=None)
def sync_sc(cfg: PhyConfig) -> np.ndarray:
    """(62,) subcarrier indices of PSS/SSS."""
    half = cfg.n_sc // 2
    return (half - 31 + np.arange(62)).astype(np.int32)


@lru_cache(maxsize=None)
def central72_sc(cfg: PhyConfig) -> np.ndarray:
    half = cfg.n_sc // 2
    return (half - 36 + np.arange(72)).astype(np.int32)


# ---------------------------------------------------------------------------
# PBCH (36.211 §6.6.4) — slot 1 symbols 0..3, central 72 sc, skipping CRS
# positions of a 4-port cell (always reserved regardless of actual n_ant).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def pbch_flat_idx(cfg: PhyConfig, n_cell_id: int) -> np.ndarray:
    """Flat indices for one frame's PBCH quarter: slot-1 symbols 0..3,
    central 72 sc, minus 4-port CRS positions (always reserved).
    240 REs normal CP, 216 extended CP."""
    vs = n_cell_id % 6
    nss = cfg.n_sym_slot
    sc = central72_sc(cfg)
    crs_syms = (0, 1, 3) if cfg.extended_cp else (0, 1)
    out = []
    for li in range(4):
        sym = nss + li
        if li in crs_syms:
            keep = sc[(sc % 3) != (vs % 3)]
        else:
            keep = sc
        out.append(sym * cfg.n_sc + keep)
    return np.concatenate(out).astype(np.int32)


# ---------------------------------------------------------------------------
# Control region REGs (36.211 §6.2.4) and PCFICH/PHICH/PDCCH mapping
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def regs_in_symbol(cfg: PhyConfig, l: int, n_cell_id: int) -> tuple[tuple[int, np.ndarray], ...]:
    """REGs of subframe-symbol l: tuple of (k0, data_sc_array(4,)).

    Symbol 0 (and the CRS symbols) have 2 REGs/RB of 6 sc with the 2 CRS
    positions excluded; non-CRS symbols have 3 REGs/RB of 4 consecutive sc.
    Symbol 1 carries CRS only for 4-port cells.
    """
    vs = n_cell_id % 6
    has_crs = (l == 0) or (l == 1 and cfg.n_ant == 4)
    regs = []
    if has_crs:
        skip = {vs % 3}
        for rb in range(cfg.n_rb_dl):
            for half in range(2):
                k0 = rb * 12 + half * 6
                ks = np.array([k0 + d for d in range(6) if (k0 + d) % 3 not in skip],
                              dtype=np.int32)
                assert len(ks) == 4
                regs.append((k0, ks))
    else:
        for rb in range(cfg.n_rb_dl):
            for third in range(3):
                k0 = rb * 12 + third * 4
                regs.append((k0, np.arange(k0, k0 + 4, dtype=np.int32)))
    return tuple(regs)


@lru_cache(maxsize=None)
def pcfich_reg_indices(cfg: PhyConfig, n_cell_id: int) -> tuple[int, ...]:
    """Indices (into regs_in_symbol(l=0)) of the 4 PCFICH quadruplets
    (36.211 §6.7.4): k̄ = 6*(N_cid mod 2*N_rb), quadruplet z at
    k = k̄ + floor(z*N_rb/2)*6 mod n_sc."""
    kbar = 6 * (n_cell_id % (2 * cfg.n_rb_dl))
    regs = regs_in_symbol(cfg, 0, n_cell_id)
    k0s = [r[0] for r in regs]
    out = []
    for z in range(4):
        k = (kbar + (z * cfg.n_rb_dl // 2) * 6) % cfg.n_sc
        out.append(k0s.index(k))
    return tuple(out)


@lru_cache(maxsize=None)
def pcfich_flat_idx(cfg: PhyConfig, n_cell_id: int) -> np.ndarray:
    """(16,) flat indices of the PCFICH's 16 REs in symbol 0."""
    regs = regs_in_symbol(cfg, 0, n_cell_id)
    idx = []
    for ri in pcfich_reg_indices(cfg, n_cell_id):
        idx.append(0 * cfg.n_sc + regs[ri][1])
    return np.concatenate(idx).astype(np.int32)


def n_phich_groups(cfg: PhyConfig, ng: float) -> int:
    """Normal duration, normal CP (36.211 §6.9)."""
    return int(np.ceil(ng * cfg.n_rb_dl / 8))


@lru_cache(maxsize=None)
def phich_reg_indices(cfg: PhyConfig, n_cell_id: int, ng: float) -> tuple[tuple[int, ...], ...]:
    """Per PHICH group m: 3 REG indices into symbol-0's non-PCFICH REG list
    (36.211 §6.9.3, normal duration): for repetition i,
    n̄_i = (floor(N_cid * n̄_0 / n̄_total) + m + floor(i*n̄_0/3)) mod n̄_0
    over REGs not assigned to PCFICH."""
    regs = regs_in_symbol(cfg, 0, n_cell_id)
    pcfich = set(pcfich_reg_indices(cfg, n_cell_id))
    avail = [i for i in range(len(regs)) if i not in pcfich]
    n0 = len(avail)
    groups = []
    for m in range(n_phich_groups(cfg, ng)):
        idxs = []
        for i in range(3):
            ni = (n_cell_id * n0 // len(regs) + m + (i * n0 // 3)) % n0
            idxs.append(avail[ni])
        groups.append(tuple(idxs))
    return tuple(groups)


@lru_cache(maxsize=None)
def phich_flat_idx(cfg: PhyConfig, n_cell_id: int, ng: float,
                   group: int) -> np.ndarray:
    """(12,) flat RE indices of PHICH group ``group`` (3 REGs in symbol 0)."""
    regs = regs_in_symbol(cfg, 0, n_cell_id)
    gidx = phich_reg_indices(cfg, n_cell_id, ng)[group]
    return np.concatenate([regs[ri][1] for ri in gidx]).astype(np.int32)


@lru_cache(maxsize=None)
def pdcch_reg_list(cfg: PhyConfig, n_cell_id: int, cfi: int,
                   ng: float) -> tuple[tuple[int, int], ...]:
    """Ordered REG pool for PDCCH after removing PCFICH+PHICH REGs.

    Returns tuple of (sym, reg_index_within_symbol), ordered by increasing k
    then increasing sym (36.211 §6.8.5 m' ordering).
    """
    used0 = set(pcfich_reg_indices(cfg, n_cell_id))
    for g in phich_reg_indices(cfg, n_cell_id, ng):
        used0.update(g)
    entries = []
    for l in range(cfi):
        regs = regs_in_symbol(cfg, l, n_cell_id)
        for ri, (k0, _) in enumerate(regs):
            if l == 0 and ri in used0:
                continue
            entries.append((k0, l, ri))
    entries.sort(key=lambda t: (t[0], t[1]))
    return tuple((l, ri) for (_k, l, ri) in entries)


@lru_cache(maxsize=None)
def pdcch_flat_idx(cfg: PhyConfig, n_cell_id: int, cfi: int,
                   ng: float) -> np.ndarray:
    """(n_pdcch_regs*4,) flat indices, REG-quadruplet m' order.

    Includes the §6.8.5 cyclic shift by N_cell_ID and the REG-level
    sub-block interleaver (applied by the channel codec via permuted
    quadruplet order — this function returns indices in *post-interleave*
    physical order; the codec composes the interleaver permutation).
    """
    pool = pdcch_reg_list(cfg, n_cell_id, cfi, ng)
    idx = []
    for (l, ri) in pool:
        regs = regs_in_symbol(cfg, l, n_cell_id)
        idx.append(l * cfg.n_sc + regs[ri][1])
    return np.stack(idx).astype(np.int32)  # (n_regs, 4)


# ---------------------------------------------------------------------------
# PDSCH allocation REs (36.211 §6.3.5 / §6.4)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def pdsch_flat_idx(cfg: PhyConfig, n_cell_id: int, cfi: int,
                   prbs: tuple[int, ...], subframe: int) -> np.ndarray:
    """Flat indices of PDSCH REs for an allocation, frequency-first per
    symbol, symbols cfi..n_sym-1, skipping CRS / PBCH / PSS / SSS REs."""
    nss = cfg.n_sym_slot
    crs_mask = crs_reserved_mask(cfg, n_cell_id)
    reserved = crs_mask.copy()
    c72 = central72_sc(cfg)
    if subframe in (0, 5):
        reserved[sss_sym(cfg), c72] = True
        reserved[pss_sym(cfg), c72] = True
    if subframe == 0:
        for li in range(4):
            reserved[nss + li, c72] = True
    sc = np.concatenate([np.arange(p * 12, p * 12 + 12) for p in sorted(prbs)])
    idx = []
    for sym in range(cfi, cfg.n_sym_subframe):
        keep = sc[~reserved[sym, sc]]
        idx.append(sym * cfg.n_sc + keep)
    return np.concatenate(idx).astype(np.int32)


# ---------------------------------------------------------------------------
# Structured flat-index extraction (gather elimination)
# ---------------------------------------------------------------------------

def make_flat_extractor(idx: np.ndarray, n_rows: int, row_len: int):
    """Build a slice/reshape-based extractor equivalent to ``x[..., idx]``
    for a flat grid of shape (..., n_rows*row_len).

    The PDSCH RE pattern is structured (whole symbols, or symbols with every 3rd subcarrier
    reserved for CRS), so the same selection is expressible as static
    slices + strided column picks — pure layout ops at HBM bandwidth.
    Rows whose keep-set has no such structure fall back to a (small)
    per-row gather.  Output ordering matches ``x[..., idx]`` exactly
    (asserted at build time).

    Returns (fn, n_structured_rows, n_gather_rows).
    """
    import jax.numpy as jnp

    idx = np.asarray(idx)
    assert idx.ndim == 1 and np.all(np.diff(idx) > 0), \
        "extractor requires strictly ascending flat indices"
    plans = []  # (row, kind, payload)
    n_struct = n_gather = 0
    rows = idx // row_len
    for row in np.unique(rows):
        k = (idx[rows == row] - row * row_len).astype(np.int64)
        a, b = int(k[0]), int(k[-1]) + 1
        if len(k) == b - a:                       # contiguous run
            plans.append((int(row), "slice", (a, b)))
            n_struct += 1
            continue
        done = False
        for p in (2, 3, 4, 6, 12):
            a0 = int(k[0] - (k[0] % p))
            b0 = a0 + ((b - a0 + p - 1) // p) * p
            if b0 > row_len:
                continue
            res = tuple(sorted(set(int(x % p) for x in k)))
            full = np.arange(a0, b0)
            want = full[np.isin(full % p, res)]
            if len(want) == len(k) and np.array_equal(want, k):
                plans.append((int(row), "periodic", (a0, b0, p, res)))
                n_struct += 1
                done = True
                break
        if not done:
            plans.append((int(row), "gather", (k.astype(np.int32),)))
            n_gather += 1

    # build-time verification: plan indices == idx, in order
    chk = []
    for row, kind, pl in plans:
        if kind == "slice":
            a, b = pl
            chk.append(np.arange(a, b) + row * row_len)
        elif kind == "periodic":
            a0, b0, p, res = pl
            blk = np.arange(a0, b0).reshape(-1, p)[:, list(res)].reshape(-1)
            chk.append(blk + row * row_len)
        else:
            chk.append(pl[0] + row * row_len)
    assert np.array_equal(np.concatenate(chk), idx)

    gidx = {row: jnp_idx for row, kind, (jnp_idx,) in
            [(r, kk, ppl) for r, kk, ppl in plans if kk == "gather"]}

    def extract(flat):
        x = flat.reshape(*flat.shape[:-1], n_rows, row_len)
        pieces = []
        for row, kind, pl in plans:
            r = x[..., row, :]
            if kind == "slice":
                a, b = pl
                pieces.append(r[..., a:b])
            elif kind == "periodic":
                a0, b0, p, res = pl
                seg = r[..., a0:b0].reshape(*r.shape[:-1], (b0 - a0) // p, p)
                cols = jnp.stack([seg[..., s] for s in res], axis=-1)
                pieces.append(cols.reshape(*r.shape[:-1], -1))
            else:
                pieces.append(r[..., jnp.asarray(pl[0])])
        return jnp.concatenate(pieces, axis=-1)

    return extract, n_struct, n_gather
