"""Tail-biting convolutional code, K=7, rate 1/3 (36.212 §5.1.3.1).

Generators G0=133, G1=171, G2=165 (octal), MSB = current input bit.
(reference capability: ``liblte/src/liblte_phy.cc :: conv_encode``.)

Design: the encoder is three circular correlations of the input
with 7-tap GF(2) filters — expressed as XOR-sums of rolled bit vectors, fully
vectorized, batchable over codewords.  No per-bit loop.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

CONV_K = 7
CONV_GEN = (0o133, 0o171, 0o165)
CONV_RATE = 3


@lru_cache(maxsize=None)
def _taps() -> np.ndarray:
    """(3, 7) uint8; taps[i, j] multiplies input bit s_{k-j}."""
    t = np.zeros((3, CONV_K), dtype=np.uint8)
    for i, g in enumerate(CONV_GEN):
        for j in range(CONV_K):
            t[i, j] = (g >> (CONV_K - 1 - j)) & 1
    return t


def conv_encode(bits: jnp.ndarray) -> jnp.ndarray:
    """Tail-biting encode.  bits (..., K) -> (..., 3, K).

    36.212 keeps the three generator streams separate (d^(0), d^(1), d^(2));
    multiplexing into transmit order happens in rate matching.  The shift
    register is initialised with the last 6 input bits (tail-biting), which
    the circular ``roll`` implements exactly.
    """
    taps = _taps()
    streams = []
    for i in range(3):
        acc = jnp.zeros_like(bits, dtype=jnp.int32)
        for j in range(CONV_K):
            if taps[i, j]:
                acc = acc + jnp.roll(bits, j, axis=-1).astype(jnp.int32)
        streams.append(acc % 2)
    return jnp.stack(streams, axis=-2)  # (..., 3, K)


# ---------------------------------------------------------------------------
# Trellis tables for the Viterbi decoder (state = previous 6 input bits,
# MSB = most recent bit;  next_state = (b << 5) | (state >> 1)).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def trellis_tables():
    """Returns (out_signs, prev_state, prev_bit_of_ns) numpy tables.

    out_signs: (64, 2, 3) float32 — 1-2*output_bit for (state, input_bit).
    prev_state: (64, 2) int32 — the two predecessors of each new state.
    ns_input: (64,) int32 — the input bit that leads *into* new state ns
              (== ns >> 5 under our encoding).
    """
    taps = _taps()
    out = np.zeros((64, 2, 3), dtype=np.int32)
    for s in range(64):
        # state bits: s_{k-1} .. s_{k-6}, s_{k-1} in bit position 5
        past = [(s >> (5 - j)) & 1 for j in range(6)]  # past[j] = s_{k-1-j}
        for b in range(2):
            window = [b] + past  # window[j] = s_{k-j}
            for i in range(3):
                out[s, b, i] = sum(taps[i, j] * window[j] for j in range(CONV_K)) % 2
    out_signs = (1 - 2 * out).astype(np.float32)
    prev_state = np.zeros((64, 2), dtype=np.int32)
    for ns in range(64):
        low5 = ns & 31
        prev_state[ns, 0] = (low5 << 1) | 0
        prev_state[ns, 1] = (low5 << 1) | 1
    ns_input = (np.arange(64) >> 5).astype(np.int32)
    return out_signs, prev_state, ns_input
