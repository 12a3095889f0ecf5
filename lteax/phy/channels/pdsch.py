"""PDSCH: downlink shared channel codec (36.212 §5.3.2, 36.211 §6.4).

(reference capability: ``liblte/src/liblte_phy.cc ::
liblte_phy_pdsch_channel_encode`` / ``liblte_phy_pdsch_channel_decode`` —
the end-to-end hot loop of the whole framework, per SURVEY.md §3.5.)

Design: segmentation/rate-matching collapse into ONE precomputed
global index vector (per transport-block geometry) so encode is a single
gather and soft de-matching a single scatter-add over all codeblocks;
scrambling is a sign flip with a matmul-generated Gold sequence; the turbo
decoder batches codeblocks.  Everything after the host-computed geometry is
jittable with static shapes.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from lteax.phy.fec.crc import attach_crc, check_crc
from lteax.phy.fec.segmentation import segment_info, segment_bits, desegment_bits, SegmentInfo
from lteax.phy.fec.turbo import turbo_encode_batch, turbo_decode_batch
from lteax.phy.fec.ratematch import turbo_rm_indices
from lteax.phy.mod import modulate, demodulate_maxlog
from lteax.phy import seq


@dataclasses.dataclass(frozen=True)
class PdschGeometry:
    """Static per-(TBS, n_re, Qm, rv) geometry."""
    tbs: int
    n_re: int
    qm: int
    rv: int
    info: SegmentInfo
    e_list: tuple[int, ...]

    @property
    def k(self) -> int:
        return self.info.k_plus

    @property
    def g(self) -> int:
        return self.n_re * self.qm


@lru_cache(maxsize=None)
def pdsch_geometry(tbs: int, n_re: int, qm: int, rv: int) -> PdschGeometry:
    info = segment_info(tbs + 24)
    if not info.uniform:
        raise NotImplementedError("non-uniform codeblock segmentation")
    g = n_re * qm
    c = info.c
    gp = g // qm
    gamma = gp % c
    e_small = qm * (gp // c)
    e_big = qm * (-(-gp // c))
    e_list = tuple([e_small] * (c - gamma) + [e_big] * gamma)
    assert sum(e_list) == g, (sum(e_list), g)
    return PdschGeometry(tbs=tbs, n_re=n_re, qm=qm, rv=rv, info=info,
                         e_list=e_list)


@lru_cache(maxsize=None)
def _global_rm_idx(geom: PdschGeometry) -> np.ndarray:
    """(G,) indices into flattened per-CB d streams (C * 3*(K+4))."""
    d_len = geom.k + 4
    parts = []
    for c, e in enumerate(geom.e_list):
        idx = turbo_rm_indices(d_len, e, geom.rv)
        parts.append(c * 3 * d_len + idx.astype(np.int64))
    return np.concatenate(parts).astype(np.int32)


@lru_cache(maxsize=None)
def _global_rm_inv(geom: PdschGeometry):
    """Inverse map for GATHER-based de-matching.

    Returns (inv (C*3D,), injective): inv[p] = position in e of d-flat bit p,
    or G (a zero sentinel) if never transmitted.  Valid only when every bit
    is transmitted at most once (no circular-buffer wrap), in which case
    soft de-matching is a gather instead of a scatter-add."""
    idx = _global_rm_idx(geom).astype(np.int64)
    d_total = geom.info.c * 3 * (geom.k + 4)
    counts = np.bincount(idx, minlength=d_total)
    injective = bool(counts.max() <= 1)
    inv = np.full(d_total, geom.g, dtype=np.int32)
    if injective:
        inv[idx] = np.arange(geom.g, dtype=np.int32)
    return inv, injective


@lru_cache(maxsize=None)
def _structured_dematch(geom: PdschGeometry):
    """Per-E-class structured (slice/concat) de-match assemblers.

    Returns ((e_offset, n_cb, e_len, fn), ...) covering the C codeblocks in
    order, or None when any class is non-injective (HARQ repetition)."""
    from lteax.phy.fec.ratematch import make_rate_unmatch_structured
    d_len = geom.k + 4
    groups = []
    off = i = 0
    e_list = geom.e_list
    while i < len(e_list):
        j = i
        while j < len(e_list) and e_list[j] == e_list[i]:
            j += 1
        out = make_rate_unmatch_structured(d_len, e_list[i], geom.rv)
        if out is None:
            return None
        groups.append((off, j - i, e_list[i], out[0]))
        off += (j - i) * e_list[i]
        i = j
    return tuple(groups)


def soft_dematch(llrs_scr: jnp.ndarray, geom: PdschGeometry,
                 structured: bool | None = None) -> jnp.ndarray:
    """Descrambled codeword LLRs (..., G) -> d-stream LLRs (..., C, 3, D).

    ``structured=True`` selects the slice/concat de-match when the rate
    matching is injective (the sub-block interleaver decomposes into strided
    runs — no gather, see ratematch.make_rate_unmatch_structured);
    ``structured=None`` resolves :class:`lteax.phy.tuning.DecoderTuning`'s
    ``struct_dematch`` knob (env-overridable); the gather is the default.
    Non-injective rate
    matching (HARQ repetition) always takes the gather-sum path."""
    import jax
    d_len = geom.k + 4
    lead = llrs_scr.shape[:-1]
    if structured is None:
        from lteax.phy.tuning import DecoderTuning
        structured = DecoderTuning.from_env().struct_dematch
    groups = _structured_dematch(geom) if structured else None
    if groups is not None:
        outs = []
        for off, n, e, fn in groups:
            seg = jax.lax.slice_in_dim(llrs_scr, off, off + n * e, axis=-1)
            outs.append(fn(seg.reshape(*lead, n, e)))
        return jnp.concatenate(outs, axis=-3)
    inv, injective = _global_rm_inv(geom)
    if injective:
        ext = jnp.concatenate(
            [llrs_scr, jnp.zeros((*lead, 1), llrs_scr.dtype)], axis=-1)
        out = ext[..., jnp.asarray(inv)]
    else:
        # circular-buffer wrap (repetition): occurrence-rank decomposition —
        # a sum of ceil(E/L) gathers instead of a serializing scatter-add,
        # so wrapped transmissions de-match at first-TX gather speed
        cycles = _global_rm_cycles(geom)
        ext = jnp.concatenate(
            [llrs_scr, jnp.zeros((*lead, 1), llrs_scr.dtype)], axis=-1)
        out = ext[..., jnp.asarray(cycles[0])]
        for k in range(1, cycles.shape[0]):
            out = out + ext[..., jnp.asarray(cycles[k])]
    return out.reshape(*lead, geom.info.c, 3, d_len)


# bounded: one (C*3D,) int32 entry per live decode geometry — a scheduler
# varying TBS per TTI must not grow these without bound
@lru_cache(maxsize=64)
def _global_rm_inv_planar(geom: PdschGeometry, npad: int) -> np.ndarray:
    """Inverse de-match map for PLANAR demap output (mod.demap_planar):
    interleaved codeword position g = s*m + j lives at planar flat position
    j*npad + s; the zero sentinel points at the appended zeros column."""
    inv, injective = _global_rm_inv(geom)
    assert injective, "planar de-match requires an injective rate match"
    m = geom.qm
    s, j = inv // m, inv % m
    out = (j * npad + s).astype(np.int64)
    out[inv == geom.g] = m * npad                    # zero sentinel
    return out.astype(np.int32)


def soft_dematch_planar(llrs_planar: jnp.ndarray, geom: PdschGeometry,
                        npad: int) -> jnp.ndarray:
    """Planar demapped LLRs (..., m, npad) -> d-stream LLRs (..., C, 3, D).

    Same result as ``soft_dematch`` on the interleaved layout — the layout
    change is absorbed into the host-precomputed gather indices."""
    lead = llrs_planar.shape[:-2]
    inv = jnp.asarray(_global_rm_inv_planar(geom, npad))
    flat = llrs_planar.reshape(*lead, -1)
    ext = jnp.concatenate(
        [flat, jnp.zeros((*lead, 1), flat.dtype)], axis=-1)
    return ext[..., inv].reshape(*lead, geom.info.c, 3, geom.k + 4)


@lru_cache(maxsize=None)
def _global_rm_cycles(geom: PdschGeometry) -> np.ndarray:
    from lteax.phy.fec.ratematch import unmatch_inv_cycles
    return unmatch_inv_cycles(_global_rm_idx(geom),
                              geom.info.c * 3 * (geom.k + 4))


def soft_dematch_harq(llrs_by_tx, geoms) -> jnp.ndarray:
    """HARQ incremental-redundancy soft combining across retransmissions.

    llrs_by_tx: iterable of descrambled codeword LLR arrays (..., G), one per
    (re)transmission; geoms: matching :class:`PdschGeometry` per transmission
    (same TBS/n_re/Qm, differing ``rv``).  Each transmission de-matches with
    its own injective gather (first-TX speed); the d-domain LLRs add.
    """
    out = None
    for llr, g in zip(llrs_by_tx, geoms):
        d = soft_dematch(llr, g)
        out = d if out is None else out + d
    return out


def _c_init(rnti, subframe, n_cell_id, codeword: int = 0):
    return (jnp.asarray(rnti, dtype=jnp.int32) * (2 ** 14)
            + codeword * (2 ** 13)
            + jnp.asarray(subframe, dtype=jnp.int32) * 512
            + jnp.asarray(n_cell_id, dtype=jnp.int32))


def pdsch_prepare_cbs(tb_bits: np.ndarray, geom: PdschGeometry) -> np.ndarray:
    """Host stage: TB payload (TBS,) -> codeblock payloads (C, K_payload)
    (CRC24A attach + segmentation, numpy)."""
    from lteax.phy.fec.crc import attach_crc_np
    b = attach_crc_np(np.asarray(tb_bits), "24A")
    return segment_bits(b, geom.info)


def pdsch_encode_cbs(cbs: jnp.ndarray, geom: PdschGeometry, rnti, subframe,
                     n_cell_id, scheme: str, codeword: int = 0) -> jnp.ndarray:
    """Device stage (fully jittable): (C, K_payload) -> (n_re,) symbols."""
    if geom.info.cb_crc:
        cbs = attach_crc(cbs, "24B")
    d = turbo_encode_batch(cbs, geom.k)              # (C, 3, K+4)
    e = d.reshape(-1)[jnp.asarray(_global_rm_idx(geom))]
    c = seq.gold_sequence(_c_init(rnti, subframe, n_cell_id, codeword),
                          geom.g)
    return modulate((e + c) % 2, scheme)


def pdsch_encode_bits(tb_bits: np.ndarray, geom: PdschGeometry) -> jnp.ndarray:
    """TB payload (TBS,) -> (G,) rate-matched codeword bits (pre-scrambling)."""
    cbs = jnp.asarray(pdsch_prepare_cbs(tb_bits, geom))
    if geom.info.cb_crc:
        cbs = attach_crc(cbs, "24B")
    d = turbo_encode_batch(cbs, geom.k)              # (C, 3, K+4)
    return d.reshape(-1)[jnp.asarray(_global_rm_idx(geom))]


def pdsch_encode(tb_bits: np.ndarray, geom: PdschGeometry, rnti, subframe,
                 n_cell_id, scheme: str, codeword: int = 0) -> jnp.ndarray:
    """-> (n_re,) modulated symbols in RE-mapping order."""
    return pdsch_encode_cbs(jnp.asarray(pdsch_prepare_cbs(tb_bits, geom)),
                            geom, rnti, subframe, n_cell_id, scheme,
                            codeword)


def pdsch_decode_llrs(llrs: jnp.ndarray, geom: PdschGeometry, rnti, subframe,
                      n_cell_id, n_iter: int = 6, codeword: int = 0):
    """Descramble + de-match + turbo decode + CRC.

    llrs: (G,) channel LLRs in codeword bit order (post-demapper).
    Returns (tb_bits (TBS,) np.ndarray | None, crc_ok, cb_crc_oks).
    """
    c = seq.gold_sequence(_c_init(rnti, subframe, n_cell_id, codeword),
                          geom.g)
    sgn = (1.0 - 2.0 * c).astype(llrs.dtype)
    d_llr = soft_dematch(llrs * sgn, geom)
    bits = turbo_decode_batch(d_llr, geom.k, n_iter=n_iter)   # (C, K)
    if geom.info.cb_crc:
        payload, cb_ok = check_crc(bits, "24B")
        cb_oks = np.asarray(cb_ok)
    else:
        payload, cb_oks = bits, np.array([True])
    tb_with_crc = desegment_bits(np.asarray(payload), geom.info)
    tb, ok = check_crc(jnp.asarray(tb_with_crc), "24A")
    return np.asarray(tb), bool(ok), cb_oks


def pdsch_symbols_to_llrs(x_eq: jnp.ndarray, eff_nv, scheme: str) -> jnp.ndarray:
    """Equalized symbols (..., n_re) -> LLRs (..., G)."""
    return demodulate_maxlog(x_eq, scheme, noise_var=eff_nv)


def desegment_device(payload: jnp.ndarray, info: SegmentInfo) -> jnp.ndarray:
    """Jittable desegmentation (uniform K): (..., C, K_payload) -> (..., B)."""
    parts = [payload[..., 0, info.f:]]
    for ci in range(1, info.c):
        parts.append(payload[..., ci, :])
    return jnp.concatenate(parts, axis=-1)


def pdsch_decode_device(llrs: jnp.ndarray, geom: PdschGeometry, rnti, subframe,
                        n_cell_id, n_iter: int = 6):
    """Fully jittable decode: (G,) llrs -> (tb_bits (TBS,), tb_ok, cb_oks).

    Same math as :func:`pdsch_decode_llrs` but with no host round-trips, so
    it can sit inside the jitted/sharded bulk-decode pipeline (bench path).
    Batched over leading axes via vmap at the call site.
    """
    c_seq = seq.gold_sequence(_c_init(rnti, subframe, n_cell_id), geom.g)
    sgn = (1.0 - 2.0 * c_seq).astype(llrs.dtype)
    d_llr = soft_dematch(llrs * sgn, geom)
    bits = turbo_decode_batch(d_llr, geom.k, n_iter=n_iter)   # (C, K)
    if geom.info.cb_crc:
        payload, cb_oks = check_crc(bits, "24B")
    else:
        payload, cb_oks = bits, jnp.ones((geom.info.c,), dtype=bool)
    tb_with_crc = desegment_device(payload, geom.info)
    tb, ok = check_crc(tb_with_crc, "24A")
    return tb, ok, cb_oks
