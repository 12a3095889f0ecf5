"""Polyphase rational resampler (P/Q) for the multi-carrier scanner
front-end.

(reference capability: none in liblte_phy — the reference runs SDRs at
native LTE rates and lets gr-osmosdr resample; BASELINE.json explicitly
requires a polyphase resampler for hackrf-style fractional rates on the
scanner path.)

Design: the P subfilters run as P strided ``lax.conv`` calls (stride Q),
then the phases interleave; XLA hands the convolutions to its convolution
library.  For sharded streams, halo-exchange ``taps-1`` samples first
(shard/halo.py) and the output is shard-invariant.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
from jax import lax


@lru_cache(maxsize=None)
def design_polyphase(p: int, q: int, taps_per_phase: int = 12,
                     beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed sinc low-pass at cutoff min(1/P, 1/Q), gain P.

    Returns (P, taps_per_phase) float32 subfilter bank: subfilter r holds
    h[r], h[r+P], h[r+2P], ...  (h of length P*taps_per_phase).
    """
    n = p * taps_per_phase
    cutoff = 1.0 / max(p, q)           # in units of the upsampled Nyquist
    k = np.arange(n) - (n - 1) / 2
    h = np.sinc(cutoff * k) * cutoff * np.kaiser(n, beta)
    h = h * p / np.sum(h)              # unity DC gain after decimation
    return h.reshape(taps_per_phase, p).T.astype(np.float32).copy()


def resample_poly(x: jnp.ndarray, p: int, q: int,
                  taps_per_phase: int = 12) -> jnp.ndarray:
    """Resample (..., L) complex by rational P/Q -> (..., ~L*P/Q).

    y[m] = sum_l h_sub[m mod P, l] * x[floor(m*Q/P) - l + D]  (group-delay
    compensated).  Output length floor(L * P / Q) (edge-trimmed).
    """
    bank = design_polyphase(p, q, taps_per_phase)       # (P, T)
    t = bank.shape[1]
    # output m = j*P + r uses subfilter (m*Q mod P) = (r*Q mod P) and input
    # base floor(m*Q/P) = j*Q + floor(r*Q/P)  (classic upfirdn identity)
    off = [(r * q) // p for r in range(p)]
    n_out_per_phase = (x.shape[-1] - t - max(off)) // q
    n_out = n_out_per_phase * p
    flat = x.reshape(-1, 1, x.shape[-1])

    outs = []
    for r in range(p):
        sub = bank[(r * q) % p]
        kern = jnp.asarray(sub[::-1].copy()).reshape(1, 1, t)
        seg = flat[..., off[r]:off[r] + n_out_per_phase * q + t - 1]
        yr = lax.conv_general_dilated(seg.real, kern, (q,), "VALID")
        yi = lax.conv_general_dilated(seg.imag, kern, (q,), "VALID")
        outs.append((yr + 1j * yi)[..., 0, :n_out_per_phase])
    y = jnp.stack(outs, axis=-1).reshape(*flat.shape[:-2], -1)  # interleave
    return y.reshape(*x.shape[:-1], n_out)
