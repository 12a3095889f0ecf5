"""PUSCH: uplink shared channel — SC-FDMA transform precoding, DM-RS,
UL-SCH coding with the channel interleaver (36.211 §5.3/§5.5, 36.212 §5.2.2).

(reference capability: ``liblte/src/liblte_phy.cc ::
liblte_phy_pusch_channel_encode`` / ``_decode``, ``generate_dmrs_pusch``.)

The design mirrors the PDSCH path: all permutations (channel
interleaver, rate matching) are host-precomputed index vectors; the DFT
transform precoding is one batched FFT; decode is gather → LS-DMRS chest →
MMSE equalize → IDFT → max-log demap → scatter-add de-match → batched
turbo.  Data-only (no UCI multiplexing yet).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from lteax.phy import seq
from lteax.phy.mod import modulate, demodulate_maxlog
from lteax.phy.channels import pdsch as pdsch_mod
from lteax.phy.channels.pdsch import PdschGeometry, pdsch_geometry

N_DATA_SYMS = 12           # normal CP: 14 symbols minus 2 DM-RS (3, 10)
DMRS_SYMS = (3, 10)


@lru_cache(maxsize=None)
def _idft_matrices(m_sc: int) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of the unitary IDFT matrix.  SC-FDMA sizes are
    non-power-of-2 (e.g. 1200 = 2^4*3*5^2); the dense matmul is the
    comparison alternative to the FFT."""
    n = np.arange(m_sc)
    w = np.exp(2j * np.pi * np.outer(n, n) / m_sc) / np.sqrt(m_sc)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def _ul_dft(x: jnp.ndarray, inverse: bool) -> jnp.ndarray:
    """Unitary transform (de)precoding over the last axis.

    ``DecoderTuning.ul_dft`` (env override ``LTEAX_UL_DFT``) selects:
      fft      — jnp.fft (XLA FFT)
      factored — Cooley–Tukey N1·N2 split as two matmuls (phy/dft.py);
                 ~17x fewer MACs than the dense-matmul alternative
      matmul   — dense unitary DFT matrix (kept for comparison)
    """
    from lteax.phy.tuning import DecoderTuning
    mode = DecoderTuning.from_env().ul_dft
    n = x.shape[-1]
    if mode == "factored":
        from lteax.phy.dft import dft_factored
        return dft_factored(x, inverse=inverse, unitary=True)
    if mode == "matmul":
        if inverse:
            return idft_unitary(x, n)
        return jnp.conj(idft_unitary(jnp.conj(x), n))
    if inverse:
        return jnp.fft.ifft(x, axis=-1) * np.sqrt(n)
    return jnp.fft.fft(x, axis=-1) / np.sqrt(n)


def idft_unitary(x: jnp.ndarray, m_sc: int) -> jnp.ndarray:
    """Unitary IDFT over the last axis via real matmuls at HIGHEST
    precision (a reduced-precision 1200-deep contraction costs 64QAM LLR
    fidelity).  An alternative to the default FFT path."""
    import jax
    wr, wi = _idft_matrices(m_sc)
    hi = jax.lax.Precision.HIGHEST
    xr, xi = jnp.real(x), jnp.imag(x)
    yr = jnp.matmul(xr, wr.T, precision=hi) - jnp.matmul(xi, wi.T, precision=hi)
    yi = jnp.matmul(xr, wi.T, precision=hi) + jnp.matmul(xi, wr.T, precision=hi)
    return (yr + 1j * yi).astype(jnp.complex64)


# ---------------------------------------------------------------------------
# UL base sequences (36.211 §5.5.1) — ZC for >= 3 PRB
# ---------------------------------------------------------------------------

def _largest_prime_below(n: int) -> int:
    for c in range(n - 1, 1, -1):
        if all(c % d for d in range(2, int(c ** 0.5) + 1)):
            return c
    raise ValueError(n)


@lru_cache(maxsize=None)
def base_sequence(u: int, m_sc: int, v: int = 0) -> np.ndarray:
    """r_{u,v}(n), length m_sc (>= 36: ZC cyclic extension; 12/24: QPSK
    phase tables — only length 12 transcribed, see PUCCH module)."""
    if m_sc >= 36:
        n_zc = _largest_prime_below(m_sc)
        qbar = n_zc * (u + 1) / 31.0
        q = int(np.floor(qbar + 0.5)) + v * (-1) ** int(np.floor(2 * qbar))
        m = np.arange(n_zc)
        x = np.exp(-1j * np.pi * q * m * (m + 1) / n_zc)
        return x[np.arange(m_sc) % n_zc].astype(np.complex64)
    if m_sc == 12:
        from lteax.phy.channels.pucch import PHI_M12
        phi = np.asarray(PHI_M12[u])
        return np.exp(1j * np.pi * phi / 4).astype(np.complex64)
    raise NotImplementedError(f"base sequence length {m_sc}")


def group_hopping_pattern(n_cell_id: int, ns: int) -> int:
    """f_gh(ns) (36.211 §5.5.1.3): 8 Gold bits per slot, mod 30."""
    c_init = n_cell_id // 30
    c = seq.gold_sequence_np(c_init, 8 * (ns + 1))
    return int(np.sum(c[8 * ns: 8 * ns + 8] * (1 << np.arange(8)))) % 30


def dmrs_pusch(n_cell_id: int, ns: int, m_sc: int, delta_ss: int = 0,
               n_dmrs: int = 0, group_hopping: bool = False) -> np.ndarray:
    """DM-RS for slot ns (§5.5.2.1): base sequence with cyclic shift alpha.

    v = 0.  n_cs = (n_dmrs + n_pn(ns)) mod 12 with n_pn from the
    §5.5.1.3-style PN sequence; group hopping optional."""
    fss = (n_cell_id + delta_ss) % 30
    fgh = group_hopping_pattern(n_cell_id, ns) if group_hopping else 0
    u = (fgh + fss) % 30
    c_init = (n_cell_id // 30) * 32 + fss
    c = seq.gold_sequence_np(c_init, 8 * (ns + 1))
    n_pn = int(np.sum(c[8 * ns: 8 * ns + 8] * (1 << np.arange(8))))
    n_cs = (n_dmrs + n_pn) % 12
    alpha = 2 * np.pi * n_cs / 12
    r = base_sequence(u, m_sc)
    n = np.arange(m_sc)
    return (np.exp(1j * alpha * n) * r).astype(np.complex64)


# ---------------------------------------------------------------------------
# Channel interleaver (36.212 §5.2.2.8, data-only)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def channel_interleaver_idx(g: int, qm: int) -> np.ndarray:
    """Index vector: out[i] = in[idx[i]] — writes row-major (Qm-bit groups,
    C_mux=12 columns), reads column-major: time-first symbol mapping."""
    c_mux = N_DATA_SYMS
    assert g % (c_mux * qm) == 0, (g, qm)
    r_mux = g // (c_mux * qm)
    # group index matrix (r_mux, c_mux) written row-wise; read column-wise
    grp = np.arange(r_mux * c_mux).reshape(r_mux, c_mux)
    order = grp.T.reshape(-1)                      # column-major group order
    idx = (order[:, None] * qm + np.arange(qm)[None, :]).reshape(-1)
    return idx.astype(np.int32)


@lru_cache(maxsize=None)
def _inv(idx_key: tuple[int, int]) -> np.ndarray:
    g, qm = idx_key
    idx = channel_interleaver_idx(g, qm)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(len(idx), dtype=np.int32)
    return inv


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PuschAlloc:
    n_prb: int
    rb_start: int
    mcs_tbs: int          # TBS value
    qm: int               # 2/4/6
    rv: int = 0

    @property
    def m_sc(self) -> int:
        return 12 * self.n_prb

    @property
    def n_re(self) -> int:
        return self.m_sc * N_DATA_SYMS

    @property
    def geom(self) -> PdschGeometry:
        return pdsch_geometry(self.mcs_tbs, self.n_re, self.qm, self.rv)

    @property
    def scheme(self) -> str:
        return {2: "qpsk", 4: "16qam", 6: "64qam"}[self.qm]


def _c_init(rnti, subframe, n_cell_id):
    return (jnp.asarray(rnti, jnp.int32) * (2 ** 14)
            + jnp.asarray(subframe, jnp.int32) * 512
            + jnp.asarray(n_cell_id, jnp.int32))


def pusch_encode_cbs(cbs: jnp.ndarray, alloc: PuschAlloc, rnti, subframe,
                     n_cell_id) -> jnp.ndarray:
    """(C, K_payload) codeblocks -> (14, m_sc) SC-FDMA frequency-domain
    grid (before mapping into the full UL resource grid)."""
    geom = alloc.geom
    from lteax.phy.fec.crc import attach_crc
    from lteax.phy.fec.turbo import turbo_encode_batch
    from lteax.phy.channels.pdsch import _global_rm_idx
    if geom.info.cb_crc:
        cbs = attach_crc(cbs, "24B")
    d = turbo_encode_batch(cbs, geom.k)
    e = d.reshape(-1)[jnp.asarray(_global_rm_idx(geom))]
    e = e[jnp.asarray(channel_interleaver_idx(geom.g, alloc.qm))]
    c = seq.gold_sequence(_c_init(rnti, subframe, n_cell_id), geom.g)
    sym = modulate((e + c) % 2, alloc.scheme)          # (n_re,)
    # transform precoding: DFT per SC-FDMA symbol (time-first order after
    # the channel interleaver: symbol s holds sym[s::12]... column-major
    # read = groups ordered by column (symbol), so consecutive m_sc entries
    # belong to one symbol.
    data = sym.reshape(N_DATA_SYMS, alloc.m_sc)
    f = _ul_dft(data, inverse=False)
    # insert DM-RS symbols
    ns0 = 2 * jnp.asarray(subframe, jnp.int32)
    grid = jnp.zeros((14, alloc.m_sc), dtype=jnp.complex64)
    data_syms = [s for s in range(14) if s not in DMRS_SYMS]
    grid = grid.at[jnp.asarray(data_syms)].set(f.astype(jnp.complex64))
    return grid


def pusch_add_dmrs(grid: np.ndarray, alloc: PuschAlloc, n_cell_id: int,
                   subframe: int, n_dmrs: int = 0) -> np.ndarray:
    """Host-side: fill DM-RS symbols (3, 10) of the (14, m_sc) grid."""
    g = np.asarray(grid).copy()
    for slot_i, sym in enumerate(DMRS_SYMS):
        ns = 2 * subframe + slot_i
        g[sym] = dmrs_pusch(n_cell_id, ns, alloc.m_sc, n_dmrs=n_dmrs)
    return g


def chest_taps(m_sc: int) -> np.ndarray:
    """Delay-domain keep-mask for PUSCH DM-RS channel-estimate denoising.

    The physical channel's delay spread fits inside the normal CP
    (144/2048 of a symbol), so the LS estimate's inverse DFT is supported
    on the first ~m_sc*144/2048 delay taps (plus a small negative-delay
    guard for timing backoff); everything else is estimation noise.
    Zeroing it cuts chest noise by ~10*log10(m_sc/n_keep) dB — ~11.5 dB at
    m_sc=1200 — which is the difference between the UL turbo converging in
    1 vs 2 full iterations at the 64QAM operating point (1462/4992
    codeblocks failed iteration 1 with the raw LS estimate, a handful with
    the denoised one)."""
    n_keep = max(4, int(np.ceil(m_sc * 144 / 2048)) + 2)
    n_guard = max(2, m_sc // 128)
    mask = np.zeros(m_sc, np.float32)
    mask[:n_keep] = 1.0
    mask[-n_guard:] = 1.0
    return mask


def chest_denoise(h_ls: jnp.ndarray) -> jnp.ndarray:
    """Project a per-subcarrier LS estimate onto the CP-span delay
    subspace (last axis = m_sc subcarriers)."""
    m_sc = h_ls.shape[-1]
    hd = jnp.fft.ifft(h_ls, axis=-1)
    return jnp.fft.fft(hd * jnp.asarray(chest_taps(m_sc)), axis=-1)


def pusch_decode(grid: jnp.ndarray, alloc: PuschAlloc, rnti, subframe,
                 n_cell_id, noise_var: float | None = None, n_dmrs: int = 0,
                 n_iter: int = 6, denoise: bool = True):
    """(14, m_sc) received SC-FDMA grid -> (tb_bits, tb_ok, cb_oks).

    LS channel estimate per slot from DM-RS (delay-domain denoised),
    linear time interpolation, MMSE equalization, IDFT de-precoding,
    max-log demap, de-interleave, de-match, turbo decode.

    ``noise_var=None`` (default) estimates the noise per subframe from the
    DM-RS residual (the two pilot symbols' raw LS difference is noise-only
    under a subframe-static channel) — same estimator as the production
    batch decoder; a float pins a static prior."""
    geom = alloc.geom
    m_sc = alloc.m_sc
    # channel estimates at DM-RS symbols
    h_slots, ls_raw = [], []
    for slot_i, sym in enumerate(DMRS_SYMS):
        ns = 2 * subframe + slot_i
        ref = jnp.asarray(dmrs_pusch(n_cell_id, ns, m_sc, n_dmrs=n_dmrs))
        h = grid[sym] * jnp.conj(ref)
        ls_raw.append(h)
        h_slots.append(chest_denoise(h) if denoise else h)
    h0, h1 = h_slots
    if noise_var is None:
        noise_var = jnp.maximum(
            jnp.mean(jnp.abs(ls_raw[0] - ls_raw[1]) ** 2) / 2.0, 1e-6)
    data_syms = [s for s in range(14) if s not in DMRS_SYMS]
    w = jnp.asarray([(s - DMRS_SYMS[0]) / (DMRS_SYMS[1] - DMRS_SYMS[0])
                     for s in data_syms], dtype=jnp.float32)
    w = jnp.clip(w, 0.0, 1.0)[:, None]
    h = (1 - w) * h0[None, :] + w * h1[None, :]        # (12, m_sc)
    y = grid[jnp.asarray(data_syms)]
    p = jnp.abs(h) ** 2
    x_f = y * jnp.conj(h) / (p + noise_var)
    scale = p / (p + noise_var)
    x_f = x_f / jnp.maximum(scale, 1e-12)
    # IDFT de-precoding
    x_t = _ul_dft(x_f, inverse=True)
    # effective post-IDFT noise: average over the symbol's subcarriers
    eff_nv = jnp.mean(noise_var / jnp.maximum(p, 1e-12), axis=-1,
                      keepdims=True) * jnp.ones_like(p)
    llr = demodulate_maxlog(x_t.reshape(-1), alloc.scheme,
                            eff_nv.reshape(-1))
    # descramble FIRST (scrambling was applied after interleaving), then
    # undo the channel interleaver
    c = seq.gold_sequence(_c_init(rnti, subframe, n_cell_id), geom.g)
    llr = llr * (1.0 - 2.0 * c).astype(llr.dtype)
    llr = llr[jnp.asarray(_inv((geom.g, alloc.qm)))]
    from lteax.phy.channels.pdsch import _global_rm_idx
    from lteax.phy.fec.turbo import turbo_decode_batch
    from lteax.phy.fec.crc import check_crc
    d_len = geom.k + 4
    buf = jnp.zeros((geom.info.c * 3 * d_len,), dtype=llr.dtype)
    buf = buf.at[jnp.asarray(_global_rm_idx(geom))].add(llr)
    bits = turbo_decode_batch(buf.reshape(geom.info.c, 3, d_len), geom.k,
                              n_iter=n_iter)
    if geom.info.cb_crc:
        payload, cb_oks = check_crc(bits, "24B")
    else:
        payload, cb_oks = bits, jnp.ones((geom.info.c,), dtype=bool)
    tb_with_crc = pdsch_mod.desegment_device(payload, geom.info)
    tb, ok = check_crc(tb_with_crc, "24A")
    return tb, ok, cb_oks


# ---------------------------------------------------------------------------
# UCI on PUSCH — HARQ-ACK / RI multiplexing (36.212 §5.2.2.6-§5.2.2.8)
# ---------------------------------------------------------------------------
#
# The channel-interleaver matrix has C_mux=12 columns (data SC-FDMA symbols,
# time order) and R'_mux = M_sc rows of Qm-bit groups.  RI groups are
# RESERVED bottom-up in columns {1,4,7,10} (data+CQI skip them); HARQ-ACK
# groups PUNCTURE bottom-up in columns {2,3,8,9} (the symbols adjacent to
# the DM-RS at l=3,10).  Q' coded symbols per UCI field:
#   Q' = min(ceil(O * M_sc * N_symb * beta_offset / sum_r K_r), 4*M_sc)
# Coded ACK/RI bits here use hypothesis-decodable repetition/simplex words
# cycled over the Qm*Q' positions (the 36.211 x/y scrambling placeholders
# are not modeled — [U], self-consistent encode/decode pair).

RI_COLS = (1, 4, 7, 10)
ACK_COLS = (2, 3, 8, 9)


@dataclasses.dataclass(frozen=True)
class PuschUci:
    """UCI multiplexing config: numbers of ACK/RI bits and beta offsets."""
    n_ack: int = 0            # 0..2 HARQ-ACK bits
    n_ri: int = 0             # 0..2 RI bits
    beta_ack: float = 2.0     # beta_offset^HARQ-ACK (36.213 Table 8.6.3-1)
    beta_ri: float = 1.25


def uci_q_prime(n_bits: int, alloc: PuschAlloc, beta: float) -> int:
    """Number of coded UCI symbols (36.212 §5.2.2.6, same-TB grant)."""
    if n_bits == 0:
        return 0
    geom = alloc.geom
    k_sum = geom.info.c * geom.k
    qp = int(np.ceil(n_bits * alloc.m_sc * N_DATA_SYMS * beta / k_sum))
    return max(1, min(qp, 4 * alloc.m_sc))


def _bottom_up_groups(q: int, cols: tuple[int, ...], r_mux: int) -> np.ndarray:
    """Group indices (row*12+col) filled bottom-up cycling the column set."""
    i = np.arange(q)
    rows = r_mux - 1 - (i // len(cols))
    colv = np.asarray(cols)[i % len(cols)]
    return (rows * N_DATA_SYMS + colv).astype(np.int32)


@lru_cache(maxsize=None)
def uci_layout(m_sc: int, qm: int, q_ri: int, q_ack: int):
    """Interleaver layout with UCI.

    Returns (read_bit_idx, data_grp, ri_grp, ack_grp):
    - read_bit_idx (n_re*qm,): output bit i (column-major symbol stream) =
      matrix_bits[read_bit_idx[i]] where matrix_bits is group-major
      (n_grp, qm) flattened.
    - data_grp (n_data_grp,): matrix group index of each data/CQI group in
      fill order (row-major, skipping reserved RI groups).
    - ri_grp (q_ri,), ack_grp (q_ack,): matrix group indices (ACK groups
      puncture data groups in place).
    """
    r_mux = m_sc
    n_grp = r_mux * N_DATA_SYMS
    ri_grp = _bottom_up_groups(q_ri, RI_COLS, r_mux)
    ack_grp = _bottom_up_groups(q_ack, ACK_COLS, r_mux)
    reserved = np.zeros(n_grp, dtype=bool)
    reserved[ri_grp] = True
    data_grp = np.nonzero(~reserved)[0].astype(np.int32)   # row-major order
    # column-major read over the (r_mux, 12) group matrix
    grp = np.arange(n_grp, dtype=np.int64).reshape(r_mux, N_DATA_SYMS)
    order = grp.T.reshape(-1)
    read_bit_idx = (order[:, None] * qm
                    + np.arange(qm)[None, :]).reshape(-1).astype(np.int32)
    return read_bit_idx, data_grp, ri_grp, ack_grp


def _uci_word(bits: tuple[int, ...], n_coded: int) -> np.ndarray:
    """Hypothesis word: repetition (1 bit) / simplex (2 bits: o0,o1,o0^o1)
    cycled over n_coded positions."""
    if len(bits) == 1:
        base = [bits[0]]
    else:
        base = [bits[0], bits[1], bits[0] ^ bits[1]]
    return np.asarray([base[i % len(base)] for i in range(n_coded)],
                      dtype=np.int32)


def alloc_geom_uci(alloc: PuschAlloc, uci: PuschUci) -> PdschGeometry:
    """Data geometry with the RI-reserved symbols removed from G."""
    q_ri = uci_q_prime(uci.n_ri, alloc, uci.beta_ri)
    return pdsch_geometry(alloc.mcs_tbs, alloc.n_re - q_ri, alloc.qm,
                          alloc.rv)


def pusch_encode_cbs_uci(cbs: jnp.ndarray, alloc: PuschAlloc, rnti, subframe,
                         n_cell_id, uci: PuschUci,
                         ack: tuple[int, ...] = (),
                         ri: tuple[int, ...] = ()) -> jnp.ndarray:
    """Like pusch_encode_cbs but multiplexing HARQ-ACK/RI bits."""
    from lteax.phy.fec.crc import attach_crc
    from lteax.phy.fec.turbo import turbo_encode_batch
    from lteax.phy.channels.pdsch import _global_rm_idx
    geom = alloc_geom_uci(alloc, uci)
    q_ri = uci_q_prime(uci.n_ri, alloc, uci.beta_ri)
    q_ack = uci_q_prime(uci.n_ack, alloc, uci.beta_ack)
    read_idx, data_grp, ri_grp, ack_grp = uci_layout(
        alloc.m_sc, alloc.qm, q_ri, q_ack)
    if geom.info.cb_crc:
        cbs = attach_crc(cbs, "24B")
    d = turbo_encode_batch(cbs, geom.k)
    e = d.reshape(-1)[jnp.asarray(_global_rm_idx(geom))]     # (g_data,)
    n_grp = alloc.m_sc * N_DATA_SYMS
    mat = jnp.zeros((n_grp, alloc.qm), dtype=e.dtype)
    mat = mat.at[jnp.asarray(data_grp)].set(e.reshape(-1, alloc.qm))
    if q_ri:
        w = _uci_word(tuple(ri), q_ri * alloc.qm).reshape(q_ri, alloc.qm)
        mat = mat.at[jnp.asarray(ri_grp)].set(jnp.asarray(w))
    if q_ack:
        w = _uci_word(tuple(ack), q_ack * alloc.qm).reshape(q_ack, alloc.qm)
        mat = mat.at[jnp.asarray(ack_grp)].set(jnp.asarray(w))
    stream = mat.reshape(-1)[jnp.asarray(read_idx)]
    g_total = alloc.n_re * alloc.qm
    c = seq.gold_sequence(_c_init(rnti, subframe, n_cell_id), g_total)
    sym = modulate((stream + c) % 2, alloc.scheme)
    data = sym.reshape(N_DATA_SYMS, alloc.m_sc)
    f = _ul_dft(data, inverse=False)
    grid = jnp.zeros((14, alloc.m_sc), dtype=jnp.complex64)
    data_syms = [s for s in range(14) if s not in DMRS_SYMS]
    return grid.at[jnp.asarray(data_syms)].set(f.astype(jnp.complex64))


def _uci_ml_decode(llrs: jnp.ndarray, n_bits: int) -> tuple[int, ...]:
    """ML decode of the repetition/simplex word from descrambled LLRs
    (positive LLR = bit 0)."""
    n = len(llrs)
    best, best_m = None, None
    for hyp in range(2 ** n_bits):
        bits = tuple((hyp >> i) & 1 for i in range(n_bits))
        w = _uci_word(bits, n)
        m = float(jnp.sum(jnp.asarray(1.0 - 2.0 * w) * llrs))
        if best_m is None or m > best_m:
            best, best_m = bits, m
    return best


def pusch_decode_uci(grid: jnp.ndarray, alloc: PuschAlloc, rnti, subframe,
                     n_cell_id, uci: PuschUci, noise_var: float = 1e-3,
                     n_dmrs: int = 0, n_iter: int = 6):
    """Receive with UCI demultiplexing.

    Returns (tb, tb_ok, cb_oks, ack_bits, ri_bits).  Punctured ACK
    positions are excluded from the data LLRs (the turbo code recovers the
    punctured bits)."""
    from lteax.phy.channels.pdsch import _global_rm_idx
    from lteax.phy.fec.turbo import turbo_decode_batch
    from lteax.phy.fec.crc import check_crc
    geom = alloc_geom_uci(alloc, uci)
    m_sc = alloc.m_sc
    q_ri = uci_q_prime(uci.n_ri, alloc, uci.beta_ri)
    q_ack = uci_q_prime(uci.n_ack, alloc, uci.beta_ack)
    read_idx, data_grp, ri_grp, ack_grp = uci_layout(m_sc, alloc.qm,
                                                     q_ri, q_ack)
    h_slots = []
    for slot_i, sym in enumerate(DMRS_SYMS):
        ns = 2 * subframe + slot_i
        ref = jnp.asarray(dmrs_pusch(n_cell_id, ns, m_sc, n_dmrs=n_dmrs))
        h_slots.append(grid[sym] * jnp.conj(ref))
    h0, h1 = h_slots
    data_syms = [s for s in range(14) if s not in DMRS_SYMS]
    w = jnp.asarray([(s - DMRS_SYMS[0]) / (DMRS_SYMS[1] - DMRS_SYMS[0])
                     for s in data_syms], dtype=jnp.float32)
    w = jnp.clip(w, 0.0, 1.0)[:, None]
    h = (1 - w) * h0[None, :] + w * h1[None, :]
    y = grid[jnp.asarray(data_syms)]
    p = jnp.abs(h) ** 2
    x_f = y * jnp.conj(h) / (p + noise_var)
    x_f = x_f / jnp.maximum(p / (p + noise_var), 1e-12)
    x_t = _ul_dft(x_f, inverse=True)
    eff_nv = jnp.mean(noise_var / jnp.maximum(p, 1e-12), axis=-1,
                      keepdims=True) * jnp.ones_like(p)
    llr = demodulate_maxlog(x_t.reshape(-1), alloc.scheme,
                            eff_nv.reshape(-1))
    g_total = alloc.n_re * alloc.qm
    c = seq.gold_sequence(_c_init(rnti, subframe, n_cell_id), g_total)
    llr = llr * (1.0 - 2.0 * c).astype(llr.dtype)
    # invert the column-major read: matrix-order LLRs
    inv = np.empty_like(read_idx)
    inv[read_idx] = np.arange(len(read_idx), dtype=np.int32)
    mat = llr[jnp.asarray(inv)].reshape(-1, alloc.qm)
    ack_bits = ri_bits = ()
    if q_ack:
        ack_bits = _uci_ml_decode(mat[jnp.asarray(ack_grp)].reshape(-1),
                                  uci.n_ack)
    if q_ri:
        ri_bits = _uci_ml_decode(mat[jnp.asarray(ri_grp)].reshape(-1),
                                 uci.n_ri)
    # data LLRs: fill-order groups, with punctured ACK groups zeroed
    zeroed = mat
    if q_ack:
        zeroed = zeroed.at[jnp.asarray(ack_grp)].set(0.0)
    d_llr = zeroed[jnp.asarray(data_grp)].reshape(-1)
    d_len = geom.k + 4
    buf = jnp.zeros((geom.info.c * 3 * d_len,), dtype=d_llr.dtype)
    buf = buf.at[jnp.asarray(_global_rm_idx(geom))].add(d_llr)
    bits = turbo_decode_batch(buf.reshape(geom.info.c, 3, d_len), geom.k,
                              n_iter=n_iter)
    if geom.info.cb_crc:
        payload, cb_oks = check_crc(bits, "24B")
    else:
        payload, cb_oks = bits, jnp.ones((geom.info.c,), dtype=bool)
    tb_with_crc = pdsch_mod.desegment_device(payload, geom.info)
    tb, ok = check_crc(tb_with_crc, "24A")
    return tb, ok, cb_oks, ack_bits, ri_bits
