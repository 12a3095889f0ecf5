"""Tail-biting Viterbi decoder for the 36.212 K=7 rate-1/3 code.

(reference capability: ``liblte/src/liblte_phy.cc :: viterbi_decode`` — a
scalar C++ trellis loop.)

Design: the add-compare-select step is vectorized over all 64
states (and over a leading batch axis via ``vmap``); the time recursion is a
``lax.scan``.  Tail-biting is handled with a wrap-around pass (WAVA, 2
passes): pass 1 from uniform metrics yields circularly-consistent start
metrics for pass 2, whose traceback from the best end state gives the
decision.  Codeword lengths here are small (PBCH 40, PDCCH ≤ 57+16), so the
scan is cheap; throughput comes from batching blind-decode candidates.

LLR convention throughout lteax: L = log P(bit=0)/P(bit=1)  (positive ⇒ 0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lteax.phy.fec.conv import trellis_tables

NEG = -1e9


def _acs_pass(llrs_3xK: jnp.ndarray, pm0: jnp.ndarray):
    """One forward pass. llrs (K, 3). Returns (final_pm, decisions (K,64))."""
    out_signs, prev_state, ns_input = trellis_tables()
    out_signs = jnp.asarray(out_signs)     # (64, 2, 3)
    prev_state = jnp.asarray(prev_state)   # (64, 2)
    ns_input = jnp.asarray(ns_input)       # (64,)

    # branch metric bm[s, b] = sum_i (1-2*out[s,b,i]) * llr[i]
    def step(pm, llr_k):
        bm = out_signs @ llr_k                       # (64, 2)
        # candidate metric for new state ns via predecessor t in {0,1}
        cand = pm[prev_state] + bm[prev_state, ns_input[:, None]]  # (64, 2)
        dec = jnp.argmax(cand, axis=1)
        pm_new = jnp.max(cand, axis=1)
        pm_new = pm_new - jnp.max(pm_new)            # normalize
        return pm_new, dec.astype(jnp.int32)

    final_pm, decs = jax.lax.scan(step, pm0, llrs_3xK)
    return final_pm, decs


def viterbi_decode_tb(llrs: jnp.ndarray, n_bits: int) -> jnp.ndarray:
    """Decode tail-biting conv code.

    llrs: (3, K) soft inputs (stream-major, L=log P0/P1).
    Returns (K,) hard bits.  ``n_bits`` must equal llrs.shape[-1] (static).
    """
    llrs_k = llrs.T  # (K, 3)
    pm0 = jnp.zeros((64,), dtype=llrs.dtype) + 0.0 * llrs_k[0, 0]
    pm1, _ = _acs_pass(llrs_k, pm0)           # wrap-around warm-up
    pm2, decs = _acs_pass(llrs_k, pm1)        # decoding pass

    start_state = jnp.argmax(pm2).astype(jnp.int32)

    # traceback (reverse scan): state at time k+1 -> emitted bit + state at k
    prev_state = jnp.asarray(trellis_tables()[1])

    def tb_step(state, dec_k):
        bit = state >> 5
        prev = prev_state[state, dec_k[state]]
        return prev, bit

    _, bits_rev = jax.lax.scan(tb_step, start_state, decs, reverse=True)
    return bits_rev.astype(jnp.int32)


viterbi_decode_tb_batch = jax.vmap(viterbi_decode_tb, in_axes=(0, None))
