"""LTE turbo code: PCCC encoder + windowed max-log-MAP decoder (36.212 §5.1.3.2).

(reference capability: ``liblte/src/liblte_phy.cc :: turbo_encode`` /
``turbo_decode`` — sequential scalar C++ trellis loops.)

Design
------
* Encoder: one ``lax.scan`` over K bits with a 3-bit register state,
  ``vmap``-batched over codeblocks.  Encoding is never the bottleneck.
* Decoder: **parallel sliding-window max-log-MAP**.  The trellis recursions
  are sequential in k, so throughput on a parallel machine must come from
  (a) batching over codeblocks and (b) splitting each block into windows
  decoded concurrently, with short acquisition warm-ups providing boundary
  metrics.  Sequential depth is O(W + ACQ) regardless of K; every scan step
  is an 8-state add-compare-select vectorized over
  (batch x n_windows x 8 states x 2 branches) — elementwise work with
  compiler-friendly static shapes.  This is the standard high-throughput
  turbo architecture (cf. TTA/ASIC decoders, PAPERS.md) recast as JAX.

Trellis: RSC with g0 = 1 + D^2 + D^3 (feedback), g1 = 1 + D + D^3.
State s = (d1, d2, d3), d1 newest;  w = b ^ d2 ^ d3;  next = (w, d1, d2);
parity z = w ^ d1 ^ d3.  Termination: 3 tail steps with b = d2 ^ d3 per
constituent, 12 tail bits multiplexed per 36.212 §5.1.3.2.2.

LLR convention: L = log P(0)/P(1) (positive ⇒ bit 0).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from lteax.phy.tables.turbo_qpp import qpp_deinterleaver, qpp_interleaver

NEG = np.float32(-1e9)  # host constant: a module-level jnp scalar would
# initialize the accelerator backend at import time
N_TAIL_D = 4  # each of the 3 d-streams carries K+4 bits (12 tail bits total)


# ---------------------------------------------------------------------------
# Trellis tables
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _trellis():
    """Forward and backward trellis tables for the 8-state RSC."""
    ns = np.zeros((8, 2), dtype=np.int32)       # next state
    psign = np.zeros((8, 2), dtype=np.float32)  # 1 - 2*parity
    for s in range(8):
        d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for b in range(2):
            w = b ^ d2 ^ d3
            z = w ^ d1 ^ d3
            ns[s, b] = (w << 2) | (d1 << 1) | d2
            psign[s, b] = 1.0 - 2.0 * z
    # predecessors: prev[s', t] for t in {0,1}; input bit & parity sign of the
    # incoming branch.
    prev = np.zeros((8, 2), dtype=np.int32)
    in_ssign = np.zeros((8, 2), dtype=np.float32)
    in_psign = np.zeros((8, 2), dtype=np.float32)
    for sp in range(8):
        cands = [(s, b) for s in range(8) for b in range(2) if ns[s, b] == sp]
        assert len(cands) == 2
        for t, (s, b) in enumerate(cands):
            prev[sp, t] = s
            in_ssign[sp, t] = 1.0 - 2.0 * b
            in_psign[sp, t] = psign[s, b]
    ssign = np.array([[1.0, -1.0]] * 8, dtype=np.float32)  # 1-2b, per (s, b)
    return ns, ssign, psign, prev, in_ssign, in_psign


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _rsc_encode(bits: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One RSC constituent.  bits (K,) -> (parity (K,), x_tail (3,), z_tail (3,))."""

    def step(s, b):
        d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        w = b ^ d2 ^ d3
        z = w ^ d1 ^ d3
        return (w << 2) | (d1 << 1) | d2, z

    s_end, parity = jax.lax.scan(step, jnp.int32(0), bits.astype(jnp.int32))

    def tail_step(s, _):
        d1, d2, d3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        b = d2 ^ d3            # forces w = 0
        z = 0 ^ d1 ^ d3
        return (d1 << 1) | d2, (b, z)

    _, (x_tail, z_tail) = jax.lax.scan(tail_step, s_end, None, length=3)
    return parity, x_tail, z_tail


def turbo_encode(bits: jnp.ndarray, k: int) -> jnp.ndarray:
    """Encode one codeblock.  bits (K,) -> d (3, K+4) streams per 36.212:

    d0 = systematic + [x_K,  z'_{K+1}, x'_K,  z'_... ] tail multiplexing:
      d0[K..K+3] = x_K,   z_{K+1}, x'_K,   z'_{K+1}
      d1[K..K+3] = z_K,   x_{K+2}, z'_K,   x'_{K+2}
      d2[K..K+3] = x_{K+1}, z_{K+2}, x'_{K+1}, z'_{K+2}
    """
    bits = bits.astype(jnp.int32)
    pi = jnp.asarray(qpp_interleaver(k))
    p1, xt1, zt1 = _rsc_encode(bits)
    p2, xt2, zt2 = _rsc_encode(bits[pi])
    d0 = jnp.concatenate([bits, jnp.stack([xt1[0], zt1[1], xt2[0], zt2[1]])])
    d1 = jnp.concatenate([p1, jnp.stack([zt1[0], xt1[2], zt2[0], xt2[2]])])
    d2 = jnp.concatenate([p2, jnp.stack([xt1[1], zt1[2], xt2[1], zt2[2]])])
    return jnp.stack([d0, d1, d2])


turbo_encode_batch = jax.vmap(turbo_encode, in_axes=(0, None))


# ---------------------------------------------------------------------------
# Windowed max-log-MAP half-iteration
# ---------------------------------------------------------------------------

def _n_windows(n: int, win: int) -> int:
    return -(-n // win)


@lru_cache(maxsize=None)
def _unrolled_wiring():
    """Constant wiring for the state-unrolled ACS.

    Returns (fwd, bwd, out0, out1):
      fwd[s'] = (p0, p1, g0, g1): a_new[s'] = max(a[p0]+γ(g0), a[p1]+γ(g1))
      bwd[s]  = (n0, n1, g0, g1): b_new[s] = max(b[n0]+γ(g0), b[n1]+γ(g1))
                 (branch order: input bit 0 then 1)
      out0[s] = (ns, g): bit-0 transition of state s;  out1[s] likewise.
    γ codes: 0=+(u+v)/2, 1=+(u-v)/2, 2=-(u-v)/2, 3=-(u+v)/2.
    """
    ns, ssign, psign, prev, in_ss, in_ps = _trellis()

    def code(ss, ps):
        if ss > 0:
            return 0 if ps > 0 else 1
        return 2 if ps > 0 else 3

    fwd = []
    for sp in range(8):
        fwd.append((int(prev[sp, 0]), int(prev[sp, 1]),
                    code(in_ss[sp, 0], in_ps[sp, 0]),
                    code(in_ss[sp, 1], in_ps[sp, 1])))
    bwd = []
    out0 = []
    out1 = []
    for s in range(8):
        g0 = code(1.0, psign[s, 0])
        g1 = code(-1.0, psign[s, 1])
        bwd.append((int(ns[s, 0]), int(ns[s, 1]), g0, g1))
        out0.append((int(ns[s, 0]), g0))
        out1.append((int(ns[s, 1]), g1))
    return tuple(fwd), tuple(bwd), tuple(out0), tuple(out1)


def _fused_sweeps(u: jnp.ndarray, v: jnp.ndarray, win: int, acq: int,
                  a_init=None, b_init=None):
    """Forward AND backward metrics in ONE scan (halves sequential steps —
    the recursion is latency-bound, not compute-bound).

    ``a_init``/``b_init`` (n_w, 8): window-boundary metrics from the
    previous turbo iteration (NII — next-iteration initialization).  With
    NII the short acquisition suffices even for heavily punctured
    high-rate transmissions, where cold uniform starts fail.

    Returns (alphas (N, 8) = alpha_k before step k,
             betas  (N, 8) = beta_{k+1} aligned to step k,
             alphas/betas as tuples of 8 per-state (N,) arrays)."""
    n = u.shape[0]
    n_w = _n_windows(n, win)
    total = acq + win
    fwd, bwd, _, _ = _unrolled_wiring()

    # alpha geometry: window w, step t -> position w*win - acq + t
    pos_a = (jnp.arange(n_w)[:, None] * win - acq + jnp.arange(total)[None, :])
    # beta geometry: backward from (w+1)*win + acq - 1
    pos_b = ((jnp.arange(n_w)[:, None] + 1) * win + acq - 1
             - jnp.arange(total)[None, :])

    def gather(pos):
        valid = (pos >= 0) & (pos < n)
        pc = jnp.clip(pos, 0, n - 1)
        return (jnp.where(valid, u[pc], 0.0).T, jnp.where(valid, v[pc], 0.0).T,
                valid.T.astype(u.dtype))   # (total, n_w) each; 1.0 == live

    ua, va, lva = gather(pos_a)
    ub, vb, lvb = gather(pos_b)

    # state-unrolled carries: tuples of 8 arrays (n_w,) — windows on lanes,
    # no minor-dim-8 layouts anywhere in the hot loop.
    def init_states(init, exact_w, exact_row):
        base = [jnp.zeros((n_w,), u.dtype) + 0.0 * u[0] for _ in range(8)]
        if init is not None:
            base = [init[:, s] for s in range(8)]
        # exact boundary: window ``exact_w`` pinned to state 0
        out = []
        for s in range(8):
            val = 0.0 if s == 0 else NEG
            out.append(base[s].at[exact_w].set(val) + 0.0 * u[0])
        return tuple(out)

    a0 = init_states(a_init, 0, 0)
    b0 = init_states(b_init, n_w - 1, 0)

    def gammas(uu, vv):
        gpp = 0.5 * (uu + vv)
        gpm = 0.5 * (uu - vv)
        return (gpp, gpm, -gpm, -gpp)

    def step(carry, inp):
        a, b = carry
        uu_a, vv_a, lv_a, uu_b, vv_b, lv_b = inp
        ga = gammas(uu_a, vv_a)
        a_new = tuple(
            jnp.maximum(a[p0] + ga[g0], a[p1] + ga[g1])
            for (p0, p1, g0, g1) in fwd)
        a_next = tuple(lv_a * an + (1.0 - lv_a) * ao
                       for an, ao in zip(a_new, a))
        gb = gammas(uu_b, vv_b)
        b_new = tuple(
            jnp.maximum(b[n0] + gb[g0], b[n1] + gb[g1])
            for (n0, n1, g0, g1) in bwd)
        b_next = tuple(lv_b * bn + (1.0 - lv_b) * bo
                       for bn, bo in zip(b_new, b))
        return (a_next, b_next), (a, b)

    (a_fin, b_fin), (alphas_t, betas_t) = jax.lax.scan(
        step, (a0, b0), (ua, va, lva, ub, vb, lvb))

    def reorder_fwd(arr):   # (total, n_w) -> (N,) ascending k
        return arr[acq:].T.reshape(n_w * win)[:n]

    def reorder_bwd(arr):
        return arr[acq:][::-1].T.reshape(n_w * win)[:n]

    alphas = tuple(reorder_fwd(x) for x in alphas_t)
    betas = tuple(reorder_bwd(x) for x in betas_t)
    a_fin = jnp.stack(a_fin, axis=-1)   # (n_w, 8) for NII bookkeeping
    b_fin = jnp.stack(b_fin, axis=-1)
    return alphas, betas, a_fin, b_fin


def _half_iteration(u, v, win, acq, inits=None):
    """Max-log-MAP half-iteration.  u = Ls+La (N,), v = Lp (N,).

    Returns (full APP LLRs L (N,), next-iteration window inits)."""
    _, _, out0, out1 = _unrolled_wiring()
    a_init, b_init = (None, None) if inits is None else inits
    alphas, betas, _, _ = _fused_sweeps(u, v, win, acq, a_init, b_init)

    gpp = 0.5 * (u + v)
    gpm = 0.5 * (u - v)
    g = (gpp, gpm, -gpm, -gpp)
    l0 = None
    l1 = None
    for s in range(8):
        ns0, g0 = out0[s]
        ns1, g1 = out1[s]
        t0 = alphas[s] + g[g0] + betas[ns0]
        t1 = alphas[s] + g[g1] + betas[ns1]
        l0 = t0 if l0 is None else jnp.maximum(l0, t0)
        l1 = t1 if l1 is None else jnp.maximum(l1, t1)
    # NII: next iteration's window w begins its acquisition at position
    # w*win - acq (alpha) / (w+1)*win + acq - 1 (beta) — seed it with THIS
    # iteration's metrics at exactly those positions.
    n = u.shape[0]
    n_w = _n_windows(n, win)
    w_idx = jnp.arange(n_w)
    a_pos = jnp.clip(w_idx * win - acq, 0, n - 1)
    b_pos = jnp.clip((w_idx + 1) * win + acq - 1, 0, n - 1)
    a_next = jnp.stack([alphas[s][a_pos] for s in range(8)], axis=-1)
    b_next = jnp.stack([betas[s][b_pos] for s in range(8)], axis=-1)
    a_next = a_next - jnp.max(a_next, axis=-1, keepdims=True)
    b_next = b_next - jnp.max(b_next, axis=-1, keepdims=True)
    return l0 - l1, (a_next, b_next)


def turbo_decode(llr_d: jnp.ndarray, k: int, n_iter: int = 8,
                 win: int = 32, acq: int = 16,
                 ext_scale: float = 0.75) -> jnp.ndarray:
    """Max-log-MAP turbo decode of one codeblock.

    llr_d: (3, K+4) channel LLRs for streams d0/d1/d2 (output of rate
    de-matching; zeros where bits were never transmitted).
    Returns (K,) hard bits.  ``ext_scale`` is the standard scaled-extrinsic
    correction for max-log-MAP (~0.7-0.75 recovers most of full-MAP).
    """
    pi = jnp.asarray(qpp_interleaver(k))
    inv = jnp.asarray(qpp_deinterleaver(k))
    d0, d1, d2 = llr_d[0], llr_d[1], llr_d[2]
    ls = d0[:k]
    lp1 = d1[:k]
    lp2 = d2[:k]
    # tail LLRs (36.212 §5.1.3.2.2 multiplexing — see turbo_encode docstring)
    sys_t1 = jnp.stack([d0[k], d2[k], d1[k + 1]])
    par_t1 = jnp.stack([d1[k], d0[k + 1], d2[k + 1]])
    sys_t2 = jnp.stack([d0[k + 2], d2[k + 2], d1[k + 3]])
    par_t2 = jnp.stack([d1[k + 2], d0[k + 3], d2[k + 3]])

    ls_int = ls[pi]
    u1_tail = sys_t1
    u2_tail = sys_t2
    v1 = jnp.concatenate([lp1, par_t1])
    v2 = jnp.concatenate([lp2, par_t2])

    n_w = _n_windows(k + 3, win)
    zero = jnp.zeros((n_w, 8), ls.dtype) + 0.0 * ls[0]  # mesh-varying type
    zero_init = (zero, zero)

    def body(carry, _):
        le21, inits1, inits2 = carry
        la1 = le21                                   # natural order
        u1 = jnp.concatenate([ls + la1, u1_tail])
        l1, inits1 = _half_iteration(u1, v1, win, acq, inits1)
        l1 = l1[:k]
        le12 = ext_scale * (l1 - ls - la1)
        la2 = le12[pi]
        u2 = jnp.concatenate([ls_int + la2, u2_tail])
        l2, inits2 = _half_iteration(u2, v2, win, acq, inits2)
        l2 = l2[:k]
        le21_int = ext_scale * (l2 - ls_int - la2)
        le21_new = le21_int[inv]
        l_total = (l2)[inv]
        return (le21_new, inits1, inits2), l_total

    (_, _, _), l_hist = jax.lax.scan(
        body, (jnp.zeros_like(ls), zero_init, zero_init), None, length=n_iter)
    l_final = l_hist[-1]
    return (l_final < 0).astype(jnp.int32)


def turbo_decode_batch(llr_d: jnp.ndarray, k: int, n_iter: int = 8,
                       win: int = 32, acq: int = 16) -> jnp.ndarray:
    """(C, 3, K+4) -> (C, K)."""
    return jax.vmap(lambda x: turbo_decode(x, k, n_iter, win, acq))(llr_d)
