"""Channel estimation and equalization (LS + interpolation, SFBC combining).

(reference capability: ``liblte/src/liblte_phy.cc ::
liblte_phy_get_dl_subframe_and_ce`` — per-RE scalar interpolation loops —
and ``de_pre_coder`` for TX-diversity combining.)

Design: LS estimates at CRS positions are lifted to the full grid by TWO
dense matmuls — a (n_sc x 2*n_rb) frequency interpolator and a
(n_sym x n_pilot_sym) time interpolator — both precomputed host-side.
Dense little matmuls replace scatter/loop interpolation and batch over
(subframe, port) for free.  Equalization/SFBC are fused elementwise work.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from lteax.phy.config import PhyConfig
from lteax.phy import seq
from lteax.phy.grid import crs_flat_idx, crs_symbols, _crs_v


@lru_cache(maxsize=None)
def _freq_interp_matrix(cfg: PhyConfig, shift: int) -> np.ndarray:
    """(n_sc, 2*n_rb) linear interpolation from the CRS comb (spacing 6,
    offset ``shift``) to all subcarriers, edge-extrapolated."""
    n_p = 2 * cfg.n_rb_dl
    pk = shift + 6 * np.arange(n_p)
    w = np.zeros((cfg.n_sc, n_p), dtype=np.float32)
    for k in range(cfg.n_sc):
        j = np.searchsorted(pk, k)
        if j == 0:
            # extrapolate from first two pilots
            a, b = 0, 1
        elif j >= n_p:
            a, b = n_p - 2, n_p - 1
        else:
            a, b = j - 1, j
        t = (k - pk[a]) / (pk[b] - pk[a])
        w[k, a] = 1 - t
        w[k, b] = t
    return w


@lru_cache(maxsize=None)
def _freq_interp_stack(cfg: PhyConfig, shifts: tuple[int, ...]) -> np.ndarray:
    """(n_ps, n_sc, 2*n_rb) f32 — per-pilot-symbol frequency interpolators
    stacked for one batched real dot (see estimate_channel)."""
    return np.stack([_freq_interp_matrix(cfg, s) for s in shifts])


@lru_cache(maxsize=None)
def _time_interp_matrix(cfg: PhyConfig, pilot_syms: tuple[int, ...]) -> np.ndarray:
    """(n_sym, n_pilot_syms) linear-in-time interpolation with edge hold."""
    ps = np.asarray(pilot_syms, dtype=np.float64)
    w = np.zeros((cfg.n_sym_subframe, len(ps)), dtype=np.float32)
    for s in range(cfg.n_sym_subframe):
        j = np.searchsorted(ps, s)
        if j == 0:
            w[s, 0] = 1.0
        elif j >= len(ps):
            w[s, -1] = 1.0
        else:
            a, b = j - 1, j
            t = (s - ps[a]) / (ps[b] - ps[a])
            w[s, a] = 1 - t
            w[s, b] = t
    return w


@lru_cache(maxsize=None)
def _crs_ref_values(cfg: PhyConfig, n_cell_id: int, port: int,
                    subframe: int) -> np.ndarray:
    """(n_pilot_syms, 2*n_rb) complex64 expected CRS values."""
    syms = crs_symbols(port, cfg)
    vals = []
    for sym in syms:
        slot = sym // cfg.n_sym_slot
        ns = 2 * subframe + slot
        l = sym % cfg.n_sym_slot
        vals.append(seq.crs_values(n_cell_id, ns, l, cfg.n_rb_dl, cfg.extended_cp))
    return np.stack(vals)


def estimate_channel(grid: jnp.ndarray, cfg: PhyConfig, n_cell_id: int,
                     subframe: int, port: int,
                     denoise: bool = False) -> jnp.ndarray:
    """LS + 2D linear interpolation.  grid (..., n_sym, n_sc) -> H same shape.

    ``denoise=True`` projects each pilot symbol's frequency-interpolated
    estimate onto the CP-span delay subspace before time interpolation
    (pusch.chest_denoise applied at the PILOT level: ~2 FFTs per pilot
    symbol instead of per data symbol) — cuts chest noise outside the CP
    support; measured to drop the 2x2 MIMO batch turbo iteration count
    3/6 -> 2/6 at 25 dB."""
    syms = crs_symbols(port, cfg)
    flat = grid.reshape(*grid.shape[:-2], -1)
    pidx = jnp.asarray(crs_flat_idx(cfg, n_cell_id, port)
                       .reshape(len(syms), 2 * cfg.n_rb_dl))
    rx = flat[..., pidx]                                  # (..., n_ps, 2n_rb)
    ref = jnp.asarray(_crs_ref_values(cfg, n_cell_id, port, subframe))
    h_ls = rx * jnp.conj(ref)                             # |ref|^2 == 1
    # Interpolation as REAL-decomposed batched dots: the weights are real,
    # and casting them complex64 makes XLA lower the interp as complex
    # convolutions.  Two f32 einsums per re/im part at HIGHEST precision
    # keep f32 accuracy (the dots are tiny).
    vs = n_cell_id % 6
    shifts = tuple((_crs_v(port, sym % cfg.n_sym_slot,
                           sym // cfg.n_sym_slot) + vs) % 6 for sym in syms)
    wf = _freq_interp_stack(cfg, shifts)                  # (n_ps, n_sc, n_p)
    hr, hi = jnp.real(h_ls), jnp.imag(h_ls)
    kw = dict(precision=jax.lax.Precision.HIGHEST,
              preferred_element_type=jnp.float32)
    fr = jnp.einsum("...pj,pkj->...pk", hr, wf, **kw)
    fi = jnp.einsum("...pj,pkj->...pk", hi, wf, **kw)
    if denoise:
        from lteax.phy.channels.pusch import chest_denoise
        h_f = chest_denoise(jax.lax.complex(fr, fi))
        fr, fi = jnp.real(h_f), jnp.imag(h_f)
    wt = np.asarray(_time_interp_matrix(cfg, syms))       # (n_sym, n_ps)
    tr = jnp.einsum("sp,...pk->...sk", wt, fr, **kw)
    ti = jnp.einsum("sp,...pk->...sk", wt, fi, **kw)
    return jax.lax.complex(tr, ti)


@lru_cache(maxsize=None)
def _mmse_pilot_corr(cfg: PhyConfig, shift: int, tau_max_us: float
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Frequency-correlation matrices for Wiener (MMSE) interpolation.

    Uniform power-delay profile over [0, tau_max]:
      r(dk) = E[H(k) H*(k+dk)] = exp(-j pi dk df tau) sinc(dk df tau).
    Returns (R_dp (n_sc, n_p), R_pp (n_p, n_p))."""
    df = 15e3
    tau = tau_max_us * 1e-6
    n_p = 2 * cfg.n_rb_dl
    # use TRUE signed FFT frequencies: the occupied band skips DC, so
    # subcarrier-index differences are off by one across the center
    bins = cfg.sc_to_fft_bin.astype(np.int64)
    f = ((bins + cfg.n_fft // 2) % cfg.n_fft) - cfg.n_fft // 2
    pk = f[shift + 6 * np.arange(n_p)]
    allk = f

    def r(dk):
        x = dk * df * tau
        return np.exp(-1j * np.pi * x) * np.sinc(x)

    r_dp = r(allk[:, None] - pk[None, :]).astype(np.complex64)
    r_pp = r(pk[:, None] - pk[None, :]).astype(np.complex64)
    return r_dp, r_pp


@lru_cache(maxsize=None)
def _wiener_matrix(cfg: PhyConfig, shift: int, tau_max_us: float,
                   nv_prior: float) -> np.ndarray:
    """Host-precomputed Wiener interpolation matrix
    W = R_dp (R_pp + nv I)^{-1} for a STATIC noise prior.

    An on-device ``jnp.linalg.solve`` of the (n_p x n_p) system runs its
    inner matmuls at the backend's default precision, which may round
    operands to bf16 or TF32 — catastrophic for this solve; Wiener
    filtering is robust to a mismatched noise prior, so folding a fixed nv
    into a host-side inverse is both faster (one matmul) and numerically
    exact."""
    r_dp, r_pp = _mmse_pilot_corr(cfg, shift, tau_max_us)
    a = r_pp + np.complex64(nv_prior) * np.eye(r_pp.shape[0],
                                               dtype=np.complex64)
    return (r_dp @ np.linalg.inv(a)).astype(np.complex64)   # (n_sc, n_p)


def _cmatmul_hi(x: jnp.ndarray, w: np.ndarray) -> jnp.ndarray:
    """x @ w.T with the complex product split into 4 real HIGHEST-precision
    matmuls (a reduced default precision would round the operands)."""
    import jax
    hi = jax.lax.Precision.HIGHEST
    wr, wi = np.ascontiguousarray(w.real.T), np.ascontiguousarray(w.imag.T)
    xr, xi = jnp.real(x), jnp.imag(x)
    yr = jnp.matmul(xr, wr, precision=hi) - jnp.matmul(xi, wi, precision=hi)
    yi = jnp.matmul(xr, wi, precision=hi) + jnp.matmul(xi, wr, precision=hi)
    return (yr + 1j * yi).astype(jnp.complex64)


def estimate_channel_mmse(grid: jnp.ndarray, cfg: PhyConfig, n_cell_id: int,
                          subframe: int, port: int, noise_var,
                          tau_max_us: float = 5.0) -> jnp.ndarray:
    """Wiener (MMSE) frequency interpolation + linear time interpolation.

    The LS->MMSE upgrade of BASELINE.json config #3: per pilot symbol,
    H = R_dp (R_pp + nv I)^{-1} h_ls, batched over pilot symbols; robust
    under frequency-selective fading where linear interpolation breaks.

    A python-float ``noise_var`` uses the host-precomputed Wiener matrix
    (exact, one matmul); a traced value falls back to the on-device solve
    (accurate only at full f32 matmul precision — see _wiener_matrix)."""
    syms = crs_symbols(port, cfg)
    flat = grid.reshape(*grid.shape[:-2], -1)
    pidx = jnp.asarray(crs_flat_idx(cfg, n_cell_id, port)
                       .reshape(len(syms), 2 * cfg.n_rb_dl))
    rx = flat[..., pidx]
    ref = jnp.asarray(_crs_ref_values(cfg, n_cell_id, port, subframe))
    h_ls = rx * jnp.conj(ref)                              # (..., n_ps, n_p)
    vs = n_cell_id % 6
    # np.floating included: host-computed noise estimates commonly arrive as
    # np.float32, and missing them would silently fall back to the on-device
    # solve (see _wiener_matrix)
    static_nv = isinstance(noise_var, (int, float, np.floating))
    if static_nv:
        # quantize to a coarse (1 dB) grid so per-subframe estimated floats
        # don't grow the lru_cache (and its O(n_p^3) host inverse) unboundedly
        nv_q = 10.0 ** (round(10.0 * np.log10(max(float(noise_var), 1e-12)))
                        / 10.0)
    else:
        nv = jnp.asarray(noise_var, dtype=jnp.complex64)
    cols = []
    for i, sym in enumerate(syms):
        slot = sym // cfg.n_sym_slot
        l = sym % cfg.n_sym_slot
        shift = (_crs_v(port, l, slot) + vs) % 6
        if static_nv:
            w = _wiener_matrix(cfg, shift, tau_max_us, nv_q)
            cols.append(_cmatmul_hi(h_ls[..., i, :], w))
        else:
            r_dp, r_pp = _mmse_pilot_corr(cfg, shift, tau_max_us)
            a = jnp.asarray(r_pp) + nv * jnp.eye(r_pp.shape[0],
                                                 dtype=jnp.complex64)
            sol = jnp.linalg.solve(a, h_ls[..., i, :][..., None])[..., 0]
            cols.append(sol @ jnp.asarray(r_dp).T)
    h_f = jnp.stack(cols, axis=-2)
    wt = jnp.asarray(_time_interp_matrix(cfg, syms)).astype(jnp.complex64)
    return jnp.einsum("sp,...pk->...sk", wt, h_f)


def estimate_noise_var(grid: jnp.ndarray, cfg: PhyConfig, n_cell_id: int,
                       subframe: int, port: int = 0) -> jnp.ndarray:
    """Noise variance from the CRS delay-domain (CIR) noise floor.

    IFFT the pilot-comb LS estimates: channel energy concentrates in early
    delay taps, so the mid-delay region is noise-only.  Unlike the naive
    second-difference estimator this is unbiased under frequency-selective
    channels (which would otherwise inflate the estimate ~6x under EVA and
    over-regularize the MMSE interpolator)."""
    syms = crs_symbols(port, cfg)
    flat = grid.reshape(*grid.shape[:-2], -1)
    pidx = jnp.asarray(crs_flat_idx(cfg, n_cell_id, port)
                       .reshape(len(syms), 2 * cfg.n_rb_dl))
    rx = flat[..., pidx]
    ref = jnp.asarray(_crs_ref_values(cfg, n_cell_id, port, subframe))
    h_ls = rx * jnp.conj(ref)                       # (..., n_ps, n_p)
    # Same-comb-shift symbol pairs (l=0 of each slot; l=4 of each slot for
    # ports 0/1): their LS difference is pure noise for channels static over
    # half a subframe — unbiased under arbitrary frequency selectivity
    # (difference/IFFT-floor/subspace estimators all leak channel power).
    # At high Doppler this gracefully over-regularizes the MMSE filter.
    n_half = h_ls.shape[-2] // 2
    d = h_ls[..., :n_half, :] - h_ls[..., n_half:2 * n_half, :]
    nv = jnp.mean(jnp.abs(d) ** 2, axis=(-2, -1)) / 2.0
    return jnp.maximum(nv, 1e-6)


def equalize_siso(grid: jnp.ndarray, h: jnp.ndarray, noise_var):
    """MMSE single-port equalizer.

    Returns (x_hat, eff_noise_var) where llr scaling uses eff_noise_var =
    noise_var / |h|^2 (post-equalization effective noise for max-log LLRs).
    """
    p = jnp.abs(h) ** 2
    x = grid * jnp.conj(h) / (p + noise_var)
    scale = p / (p + noise_var)            # bias correction
    x = x / jnp.maximum(scale, 1e-12)
    eff_nv = noise_var / jnp.maximum(p, 1e-12)
    return x, eff_nv


def equalize_res(y: jnp.ndarray, h0: jnp.ndarray, h1, noise_var, n_ant: int):
    """Equalize gathered REs (channel-mapping order): SISO or 2-port SFBC.

    y, h0[, h1]: (..., n_re).  Returns (x_hat, eff_noise_var)."""
    if n_ant == 1:
        return equalize_siso(y, h0, noise_var)
    return combine_sfbc(y, h0, h1, noise_var)


def equalize_mrc(y: jnp.ndarray, h: jnp.ndarray, noise_var):
    """Maximum-ratio combining over RX antennas (1 TX layer, N_rx >= 1).

    y, h: (..., n_rx, n_re) received REs and per-antenna channel.
    Returns (x_hat (..., n_re), eff_noise_var (..., n_re)): matched-filter
    combine x = sum_r conj(h_r) y_r / sum_r |h_r|^2, post-combining noise
    nv / sum_r |h_r|^2 — the receive-diversity upgrade of equalize_siso
    (which it reduces to at n_rx=1)."""
    p = jnp.sum(jnp.abs(h) ** 2, axis=-2)
    x = jnp.sum(jnp.conj(h) * y, axis=-2) / jnp.maximum(p, 1e-12)
    return x, noise_var / jnp.maximum(p, 1e-12)


def combine_sfbc_mrc(y: jnp.ndarray, h0: jnp.ndarray, h1: jnp.ndarray,
                     noise_var):
    """SFBC (2 TX ports) + MRC over RX antennas.

    y, h0, h1: (..., n_rx, n_re) with n_re even; Alamouti combining summed
    across receive antennas (diversity order 2*n_rx)."""
    y0, y1 = y[..., 0::2], y[..., 1::2]
    g0, g1 = h0[..., 0::2], h1[..., 0::2]
    p = jnp.sum(jnp.abs(g0) ** 2 + jnp.abs(g1) ** 2, axis=-2)
    x0 = jnp.sum(jnp.conj(g0) * y0 + g1 * jnp.conj(y1),
                 axis=-2) / jnp.maximum(p, 1e-12)
    x1 = jnp.sum(jnp.conj(g0) * y1 - g1 * jnp.conj(y0),
                 axis=-2) / jnp.maximum(p, 1e-12)
    lead = y.shape[:-2]
    x = jnp.stack([x0, x1], axis=-1).reshape(*lead, -1)
    eff = noise_var / jnp.maximum(p, 1e-12)
    eff_nv = jnp.stack([eff, eff], axis=-1).reshape(*lead, -1)
    return x * jnp.sqrt(2.0), eff_nv * 2.0


def combine_sfbc(y: jnp.ndarray, h0: jnp.ndarray, h1: jnp.ndarray, noise_var):
    """Alamouti (SFBC, 2 TX ports, 36.211 §6.3.4.3) combining.

    y, h0, h1: (..., n_re) with n_re even; RE pairs (2i, 2i+1) carry
    (x0, x1) as  y0 = h0·x0 - h1·x1*,  y1 = h0·x1 + h1·x0*   (up to the
    standard 1/sqrt(2) precoder scaling).
    Returns (x_hat (..., n_re), eff_noise_var).
    """
    y0, y1 = y[..., 0::2], y[..., 1::2]
    g0, g1 = h0[..., 0::2], h1[..., 0::2]   # channel ~constant over the pair
    p = jnp.abs(g0) ** 2 + jnp.abs(g1) ** 2
    x0 = (jnp.conj(g0) * y0 + g1 * jnp.conj(y1)) / jnp.maximum(p, 1e-12)
    x1 = (jnp.conj(g0) * y1 - g1 * jnp.conj(y0)) / jnp.maximum(p, 1e-12)
    x = jnp.stack([x0, x1], axis=-1).reshape(*y.shape[:-1], -1)
    eff = noise_var / jnp.maximum(p, 1e-12)
    eff_nv = jnp.stack([eff, eff], axis=-1).reshape(*y.shape[:-1], -1)
    # undo the sqrt(2) SFBC precoder normalization so constellation scale is 1
    return x * jnp.sqrt(2.0), eff_nv * 2.0


def precode_sfbc_fstd(x: jnp.ndarray):
    """TX: 4-port SFBC+FSTD (36.211 §6.3.4.3).  x (..., n), n % 4 == 0.

    Quadruplet (x0,x1,x2,x3): ports (0,2) carry the Alamouti pair (x0,x1) on
    REs (0,1); ports (1,3) carry (x2,x3) on REs (2,3).  Returns 4 arrays."""
    s = 1.0 / np.sqrt(2.0)
    q = x.reshape(*x.shape[:-1], -1, 4)
    z = jnp.zeros_like(q[..., 0])
    p0 = jnp.stack([q[..., 0], q[..., 1], z, z], axis=-1)
    p2 = jnp.stack([-jnp.conj(q[..., 1]), jnp.conj(q[..., 0]), z, z], axis=-1)
    p1 = jnp.stack([z, z, q[..., 2], q[..., 3]], axis=-1)
    p3 = jnp.stack([z, z, -jnp.conj(q[..., 3]), jnp.conj(q[..., 2])], axis=-1)
    flat = lambda p: p.reshape(*x.shape[:-1], -1) * s
    return flat(p0), flat(p1), flat(p2), flat(p3)


def combine_sfbc_fstd(y: jnp.ndarray, h0, h1, h2, h3, noise_var):
    """RX: 4-port SFBC+FSTD combining.  y, h* (..., n) with n % 4 == 0."""
    q = y.reshape(*y.shape[:-1], -1, 4)
    g0 = h0.reshape(*y.shape[:-1], -1, 4)[..., 0]
    g2 = h2.reshape(*y.shape[:-1], -1, 4)[..., 0]
    g1 = h1.reshape(*y.shape[:-1], -1, 4)[..., 2]
    g3 = h3.reshape(*y.shape[:-1], -1, 4)[..., 2]
    pa = jnp.abs(g0) ** 2 + jnp.abs(g2) ** 2
    pb = jnp.abs(g1) ** 2 + jnp.abs(g3) ** 2
    x0 = (jnp.conj(g0) * q[..., 0] + g2 * jnp.conj(q[..., 1])) / jnp.maximum(pa, 1e-12)
    x1 = (jnp.conj(g0) * q[..., 1] - g2 * jnp.conj(q[..., 0])) / jnp.maximum(pa, 1e-12)
    x2 = (jnp.conj(g1) * q[..., 2] + g3 * jnp.conj(q[..., 3])) / jnp.maximum(pb, 1e-12)
    x3 = (jnp.conj(g1) * q[..., 3] - g3 * jnp.conj(q[..., 2])) / jnp.maximum(pb, 1e-12)
    x = jnp.stack([x0, x1, x2, x3], axis=-1).reshape(*y.shape[:-1], -1)
    ea = noise_var / jnp.maximum(pa, 1e-12)
    eb = noise_var / jnp.maximum(pb, 1e-12)
    eff = jnp.stack([ea, ea, eb, eb], axis=-1).reshape(*y.shape[:-1], -1)
    return x * jnp.sqrt(2.0), eff * 2.0


def precode_sfbc(x: jnp.ndarray):
    """TX side: map symbol pairs to 2 ports (36.211 §6.3.4.3).

    x (..., n) with n even -> (y_p0, y_p1) each (..., n):
      port0 carries [x0, x1]/sqrt(2); port1 carries [-x1*, x0*]/sqrt(2).
    """
    x0, x1 = x[..., 0::2], x[..., 1::2]
    s = 1.0 / np.sqrt(2.0)
    p0 = jnp.stack([x0, x1], axis=-1).reshape(*x.shape[:-1], -1) * s
    p1 = jnp.stack([-jnp.conj(x1), jnp.conj(x0)], axis=-1).reshape(*x.shape[:-1], -1) * s
    return p0, p1
