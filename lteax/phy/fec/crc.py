"""CRC attachment/check per 3GPP TS 36.212 §5.1.1.

(reference capability: ``liblte/src/liblte_phy.cc :: calc_crc`` — a serial
bit-loop in C++.)

Design: CRC over GF(2) is a *linear* map, so for a fixed message length N
the CRC is ``(bits @ M) mod 2`` with a precomputed (N, L) contribution
matrix — one matmul that batches for free over codewords (0/1 operands
with f32 or int accumulation are exact under any matmul precision).  No bit-serial loop ever runs on device.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

# name -> (L, generator low bits).  g(x) = x^L + poly_low  (36.212 §5.1.1)
CRC_POLYS: dict[str, tuple[int, int]] = {
    "24A": (24, 0x864CFB),  # D^24+D^23+D^18+D^17+D^14+D^11+D^10+D^7+D^6+D^5+D^4+D^3+D+1
    "24B": (24, 0x800063),  # D^24+D^23+D^6+D^5+D+1
    "16": (16, 0x1021),     # D^16+D^12+D^5+1
    "8": (8, 0x9B),         # D^8+D^7+D^4+D^3+D+1
}


@lru_cache(maxsize=None)
def crc_matrix(n_bits: int, kind: str) -> np.ndarray:
    """(n_bits, L) uint8 matrix: crc(m) = m @ M mod 2 (m MSB-first)."""
    L, poly = CRC_POLYS[kind]
    mask = (1 << L) - 1
    # remainder r_i = x^{(n_bits-1-i)+L} mod g(x); build from last bit upward.
    r = 1  # x^0; multiply by x repeatedly to reach x^{L}, then onward
    rems = np.zeros((n_bits, L), dtype=np.uint8)
    # advance to x^L mod g  == poly_low
    for _ in range(L):
        r <<= 1
        if r >> L:
            r = (r & mask) ^ poly
    for i in range(n_bits):  # i counts from the LAST message bit backwards
        rems[n_bits - 1 - i] = [(r >> (L - 1 - j)) & 1 for j in range(L)]
        r <<= 1
        if r >> L:
            r = (r & mask) ^ poly
    return rems


def crc_np(bits: np.ndarray, kind: str) -> np.ndarray:
    """Host/numpy CRC (for host-side prep stages)."""
    m = crc_matrix(bits.shape[-1], kind).astype(np.int64)
    return (bits.astype(np.int64) @ m) % 2


def attach_crc_np(bits: np.ndarray, kind: str, mask_bits=None) -> np.ndarray:
    p = crc_np(bits, kind)
    if mask_bits is not None:
        p = (p + np.asarray(mask_bits)) % 2
    return np.concatenate([bits.astype(np.int64), p], axis=-1)


def crc(bits: jnp.ndarray, kind: str) -> jnp.ndarray:
    """CRC of ``bits`` (..., N) int -> (..., L) int32 parity bits (MSB first)."""
    n = bits.shape[-1]
    m = jnp.asarray(crc_matrix(n, kind), dtype=jnp.int32)
    return (bits.astype(jnp.int32) @ m) % 2


def attach_crc(bits: jnp.ndarray, kind: str, mask_bits=None) -> jnp.ndarray:
    """Append CRC parity (optionally XOR-masked, e.g. PBCH antenna mask or
    PDCCH RNTI mask per 36.212 §5.3.1.1 / §5.3.3.2)."""
    p = crc(bits, kind)
    if mask_bits is not None:
        p = (p + jnp.asarray(mask_bits, dtype=p.dtype)) % 2
    return jnp.concatenate([bits.astype(jnp.int32), p], axis=-1)


def check_crc(bits_with_crc: jnp.ndarray, kind: str, mask_bits=None):
    """Split and verify. Returns (payload, ok_bool)."""
    L, _ = CRC_POLYS[kind]
    payload, rx_par = bits_with_crc[..., :-L], bits_with_crc[..., -L:]
    p = crc(payload, kind)
    if mask_bits is not None:
        p = (p + jnp.asarray(mask_bits, dtype=p.dtype)) % 2
    ok = jnp.all(p == rx_par.astype(p.dtype), axis=-1)
    return payload, ok
