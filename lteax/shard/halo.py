"""Overlap-save halo exchange over the time axis (SURVEY.md C6).

Filtering/correlation stages (CP autocorrelation window, PSS matched filter,
polyphase resampler taps) need ``halo`` samples from the *next* time shard to
produce valid outputs for their own region.  Under ``shard_map`` each shard
appends its right neighbor's head via ``lax.ppermute`` — the sharded
replacement for the reference's contiguous in-memory buffers.

Shard-invariance (decoded bits identical for 1 vs N shards) is the
correctness oracle — tests/test_shard.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def exchange_right_halo(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """x (..., L) per shard -> (..., L + halo) with the next shard's first
    ``halo`` samples appended.  The last shard receives zeros (capture edge).
    """
    n = lax.axis_size(axis_name)
    head = x[..., :halo]
    # send my head to my LEFT neighbor (shard i receives from i+1)
    perm = [(i, (i - 1) % n) for i in range(n)]
    recv = lax.ppermute(head, axis_name, perm)
    idx = lax.axis_index(axis_name)
    recv = jnp.where(idx == n - 1, jnp.zeros_like(recv), recv)
    return jnp.concatenate([x, recv], axis=-1)


def overlap_save_correlate(x: jnp.ndarray, taps: jnp.ndarray,
                           axis_name: str) -> jnp.ndarray:
    """Sharded 'valid-start' correlation:  y[n] = sum_k x[n+k] conj(taps[k]),
    defined for every n in the local shard, using halo samples for the tail.

    x: (..., L) local samples; taps: (K,).  Returns (..., L).
    """
    k = taps.shape[-1]
    ext = exchange_right_halo(x, k - 1, axis_name)
    # XLA conv is cross-correlation (no kernel flip): out[n] = sum_k in[n+k]w[k]
    # so with w = conj(taps):  y = (xr*tr + xi*ti) + j(xi*tr - xr*ti)
    flat = ext.reshape(-1, 1, ext.shape[-1])
    tr = jnp.real(taps).reshape(1, 1, k).astype(jnp.float32)
    ti = jnp.imag(taps).reshape(1, 1, k).astype(jnp.float32)
    xr, xi = jnp.real(flat), jnp.imag(flat)
    yr = lax.conv_general_dilated(xr, tr, (1,), "VALID") \
        + lax.conv_general_dilated(xi, ti, (1,), "VALID")
    yi = lax.conv_general_dilated(xi, tr, (1,), "VALID") \
        - lax.conv_general_dilated(xr, ti, (1,), "VALID")
    y = (yr + 1j * yi).reshape(*ext.shape[:-1], -1)
    return y[..., : x.shape[-1]]
