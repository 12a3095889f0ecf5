"""Fast batched turbo RE-encoder for interference cancellation (MIMO SIC).

The RSC constituents are GF(2)-LINEAR: every parity bit and every tail bit
is an XOR of input bits.  So a whole-codeblock encode is one bit-matrix
product — (B, K) @ (K, K+6) — instead of the K-step ``lax.scan`` in
:func:`lteax.phy.fec.turbo._rsc_encode` (fine for offline encode, K
sequential steps under jit).  0/1 inputs are exact in TF32 and bf16 and the
product accumulates in f32 (sums < 2^24), so the mod-2 of the f32
accumulator is exact.

(reference capability: none — liblte_phy has no receiver-side cancellation;
SURVEY.md §2.2 layer-map row marks spatial multiplexing as beyond-reference.)
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from lteax.phy.tables.turbo_qpp import qpp_interleaver


def _rsc_step_np(s: int, b: int) -> tuple[int, int]:
    """Mirror of turbo._rsc_encode's step: state s (3 bits), input b."""
    d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
    w = b ^ d2 ^ d3
    z = w ^ d1 ^ d3
    return (w << 2) | (d1 << 1) | d2, z


def _rsc_tails_np(s: int) -> tuple[list[int], list[int]]:
    """Mirror of turbo._rsc_encode's tail_step ×3 from end state s."""
    x_t, z_t = [], []
    for _ in range(3):
        d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        b = d2 ^ d3
        z = d1 ^ d3
        s = (d1 << 1) | d2
        x_t.append(b)
        z_t.append(z)
    return x_t, z_t


@lru_cache(maxsize=4)
def _rsc_matrix(k: int) -> np.ndarray:
    """(K, K+6) uint8 GF(2) matrix: input bits -> [parity(K), x_tail(3),
    z_tail(3)] for one RSC constituent.

    Built from the impulse response (the encoder is time-invariant): column
    block j of the parity part is the length-(K-j) prefix of the impulse
    parity response h; the 6 tail outputs are linear in the end state,
    which for an impulse at j is the state response after K-j steps."""
    # impulse response: parity h[n] and state s_n after n steps, input e_0
    h = np.zeros(k, dtype=np.uint8)
    states = np.zeros(k + 1, dtype=np.int32)   # states[n] = state after n in
    s = 0
    for n in range(k):
        s, z = _rsc_step_np(s, 1 if n == 0 else 0)
        h[n] = z
        states[n + 1] = s
    m = np.zeros((k, k + 6), dtype=np.uint8)
    for j in range(k):
        m[j, j:k] = h[: k - j]
        x_t, z_t = _rsc_tails_np(int(states[k - j]))
        m[j, k:k + 3] = x_t
        m[j, k + 3:k + 6] = z_t
    return m


def _rsc_matrix_dev(k: int):
    # f32 storage: 0/1 is exact in any float dtype.
    # NOT lru_cached: under shard_map tracing, array creation returns a
    # trace-bound tracer — caching it leaks the tracer into later traces
    # (only the numpy matrix above is cached; this is a per-trace constant)
    return jnp.asarray(_rsc_matrix(k), dtype=jnp.float32)


def turbo_reencode_batch(bits: jnp.ndarray, k: int) -> jnp.ndarray:
    """(B, K) decoded codeblock bits -> (B, 3, K+4) d streams, numerically
    identical to ``turbo_encode_batch`` (tests pin this) but two
    matmuls instead of 2K sequential scan steps."""
    m = _rsc_matrix_dev(k)
    pi = jnp.asarray(qpp_interleaver(k))
    # 0/1 operands with f32 accumulation: exact under any matmul precision
    # (TF32 and bf16 represent 0 and 1 exactly; sums stay < 2^24)
    bf = bits.astype(jnp.float32)
    md = m
    o1 = jnp.mod(jnp.matmul(bf, md, preferred_element_type=jnp.float32), 2.0)
    o2 = jnp.mod(jnp.matmul(bf[:, pi], md,
                            preferred_element_type=jnp.float32), 2.0)
    o1 = o1.astype(jnp.int32)
    o2 = o2.astype(jnp.int32)
    p1, xt1, zt1 = o1[:, :k], o1[:, k:k + 3], o1[:, k + 3:k + 6]
    p2, xt2, zt2 = o2[:, :k], o2[:, k:k + 3], o2[:, k + 3:k + 6]
    bits = bits.astype(jnp.int32)
    # tail multiplexing identical to turbo.turbo_encode
    d0 = jnp.concatenate([bits, jnp.stack(
        [xt1[:, 0], zt1[:, 1], xt2[:, 0], zt2[:, 1]], axis=1)], axis=1)
    d1 = jnp.concatenate([p1, jnp.stack(
        [zt1[:, 0], xt1[:, 2], zt2[:, 0], xt2[:, 2]], axis=1)], axis=1)
    d2 = jnp.concatenate([p2, jnp.stack(
        [xt1[:, 1], zt1[:, 2], xt2[:, 1], zt2[:, 2]], axis=1)], axis=1)
    return jnp.stack([d0, d1, d2], axis=1)
