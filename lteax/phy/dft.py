"""Factored DFT/IDFT for SC-FDMA transform precoding sizes.

(reference capability: the FFTW plans behind ``liblte_phy`` UL transform
precoding — ``liblte_phy_pusch_channel_encode``'s DFT spreading.)

LTE UL M_sc = 12·N_PRB is never a power of two (2^a·3^b·5^c).  A dense
DFT matmul costs N² MACs at HIGHEST precision.  This module splits N = N1·N2 (Cooley–Tukey) into two
small matmuls plus a twiddle, cutting the contraction work from N² to
N·(N1+N2) — ~17× fewer MACs at N=1200=30×40 — while keeping every
contraction shallow enough that precision stays cheap.

Identity (decimation in time, n = n1 + N1·n2, k = N2·k1 + k2):
  X[N2·k1+k2] = Σ_{n1} W_N^{±n1·k2} W_{N1}^{±n1·k1} Σ_{n2} x[n1+N1·n2] W_{N2}^{±n2·k2}
i.e. inner DFT_{N2} along n2, twiddle by W_N^{n1·k2}, outer DFT_{N1} along n1.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp


@lru_cache(maxsize=None)
def _split(n: int) -> tuple[int, int]:
    """Factor pair (n1, n2), n1·n2 = n, closest to sqrt(n).  (1, n) if prime."""
    best = (1, n)
    for d in range(2, int(n ** 0.5) + 1):
        if n % d == 0:
            best = (d, n // d)
    return best


@lru_cache(maxsize=None)
def _consts(n: int, inverse: bool) -> tuple:
    n1, n2 = _split(n)
    sign = 2j if inverse else -2j
    w1 = np.exp(sign * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    w2 = np.exp(sign * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    # twiddle[k2, n1] = W_N^{±n1·k2}
    tw = np.exp(sign * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n)
    c64 = np.complex64
    return n1, n2, w1.astype(c64), w2.astype(c64), tw.astype(c64)


def _cmatmul(a, b) -> jnp.ndarray:
    """a @ b with complex split into 4 real HIGHEST-precision matmuls
    (a reduced default precision would round each contraction)."""
    hi = jax.lax.Precision.HIGHEST
    ar, ai = jnp.real(jnp.asarray(a)), jnp.imag(jnp.asarray(a))
    br, bi = jnp.real(jnp.asarray(b)), jnp.imag(jnp.asarray(b))
    yr = jnp.matmul(ar, br, precision=hi) - jnp.matmul(ai, bi, precision=hi)
    yi = jnp.matmul(ar, bi, precision=hi) + jnp.matmul(ai, br, precision=hi)
    return (yr + 1j * yi).astype(jnp.complex64)


def dft_factored(x: jnp.ndarray, inverse: bool = False,
                 unitary: bool = False) -> jnp.ndarray:
    """DFT (or IDFT) over the last axis via two small matmuls.

    Matches ``np.fft.fft`` / ``np.fft.ifft`` conventions; ``unitary=True``
    scales by 1/sqrt(N) instead (both directions), matching the SC-FDMA
    unitary transform pair.  Falls back to a single dense matmul for prime N.
    """
    n = x.shape[-1]
    n1, n2, w1, w2, tw = _consts(n, inverse)
    lead = x.shape[:-1]
    if n1 == 1:                         # prime: dense W (w2 is the full DFT)
        y = _cmatmul(x, w2.T)
    else:
        # V[..., n2, n1] = x[..., n1 + N1*n2]
        v = x.reshape(*lead, n2, n1)
        # inner DFT_{N2} along the n2 axis: A[..., k2, n1] (jnp.matmul
        # broadcasts the (N2, N2) constant over leading batch axes)
        a = _cmatmul(w2, v)
        a = a * tw                      # twiddle (k2, n1)
        # outer DFT_{N1} along n1: C[..., k2, k1]
        c = _cmatmul(a, w1)
        # X[N2*k1 + k2] = C[k2, k1]
        y = jnp.swapaxes(c, -1, -2).reshape(*lead, n)
    if unitary:
        return y * np.float32(1.0 / np.sqrt(n))
    if inverse:
        return y * np.float32(1.0 / n)
    return y
