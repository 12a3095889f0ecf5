"""OFDM modulation/demodulation with cyclic prefix (36.211 §6.12).

(reference capability: ``liblte/src/liblte_phy.cc :: symbols_to_samples`` /
``samples_to_symbols`` — per-symbol FFTW3F plans with hand-rolled CP copies.)

Design: a whole subframe's 14 FFTs run as ONE batched ``jnp.fft.fft``,
with CP handling expressed as static slices — no per-symbol host loop, fully batchable over (subframe, carrier) leading
axes.  Normalisation is orthonormal (1/sqrt(N) both ways) so resource-element
power is preserved.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from lteax.phy.config import PhyConfig


@lru_cache(maxsize=None)
def _symbol_sample_gather(cfg: PhyConfig) -> np.ndarray:
    """(n_sym, n_fft) sample indices of each symbol's data part in a subframe."""
    starts = cfg.symbol_starts_subframe
    return (np.asarray(starts)[:, None] + np.arange(cfg.n_fft)[None, :]).astype(np.int32)


def subframe_to_samples(grid: jnp.ndarray, cfg: PhyConfig) -> jnp.ndarray:
    """Resource grid (..., n_sym, n_sc) -> time samples (..., n_samps_subframe)."""
    n_sym = cfg.n_sym_subframe
    bins = jnp.asarray(cfg.sc_to_fft_bin)
    freq = jnp.zeros((*grid.shape[:-1], cfg.n_fft), dtype=jnp.complex64)
    freq = freq.at[..., bins].set(grid.astype(jnp.complex64))
    time = jnp.fft.ifft(freq, axis=-1).astype(jnp.complex64) * np.sqrt(cfg.n_fft)
    # prepend each symbol's CP, concatenate
    cps = list(cfg.cp_lengths_slot) * 2
    parts = []
    for s in range(n_sym):
        sym = time[..., s, :]
        parts.append(jnp.concatenate([sym[..., -cps[s]:], sym], axis=-1))
    return jnp.concatenate(parts, axis=-1)


def samples_to_subframe(samples: jnp.ndarray, cfg: PhyConfig) -> jnp.ndarray:
    """Time samples (..., n_samps_subframe) -> resource grid (..., n_sym, n_sc).

    Assumes the subframe boundary is sample 0 (sync already applied).
    Symbol blocks are cut with static slices (symbol starts are config
    constants)."""
    import jax
    blocks = jnp.stack(
        [jax.lax.slice_in_dim(samples, st, st + cfg.n_fft, axis=-1)
         for st in cfg.symbol_starts_subframe], axis=-2)  # (..., n_sym, n_fft)
    freq = jnp.fft.fft(blocks, axis=-1).astype(jnp.complex64) / np.sqrt(cfg.n_fft)
    return freq[..., jnp.asarray(cfg.sc_to_fft_bin)]
