"""Windowed max-log-MAP half-iteration: a Pallas kernel for the GPU (Triton
route) and a plain ``lax.scan`` version of the same contract, plus the
batched turbo decode driver built on them.

Contract (``half_iteration``): step-major operands ``um``/``vm``
``(win, n_w, cpad)`` — value at trellis position ``p = w*win + j`` of
codeblock ``c`` lives at ``[j, w, c]``, codeblocks on the minor axis — and
window-boundary inits ``a_l``/``b_l`` ``(n_w, 8, cpad)``.  Returns the APP
LLRs in the same layout and the next-iteration window inits (NII), already
shifted into init position and normalised.

Every (window, codeblock) pair is an independent trellis chain: an
``acq``-step acquisition warms the alpha/beta metrics up from the
neighbouring windows, then the alpha and beta sweeps run in one loop and
meet in the middle of the window.  The first half stores each chain's
pre-step metrics (half a window of alphas and betas); the second half
combines every live metric at once with the opposing stored one, so the
APP LLRs come out without a separate combine pass.

The GPU kernel runs each chain in one thread: the 8 alpha and 8 beta
metrics stay in registers, and the half-window stores go to a global
scratch, one slot per program.  The plain version writes
every step's metrics as ``ys`` and combines afterwards; it is the reference
on the GPU and the implementation everywhere else.

Arithmetic shared by both:
  * dead positions (past the trellis end) of the beta sweep are pinned by
    data — u += PIN — instead of per-step freeze blends (see ``PIN``);
  * bf16 metrics are renormalised (state 0 subtracted) every 4 steps;
  * the output combine runs in f32 whatever the metric dtype.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

NEG = -1e9

PIN = 512.0
"""Pinned-padding magnitude: dead positions get u=+PIN, making the state-0
self-loop branch (sys=0, par=0, gamma=+(u+v)/2) dominate every dead trellis
step.  The backward metrics then converge to the constant profile
[0, -PIN, ..., -PIN] — an effective termination pin with margin PIN, with
no per-step freeze blend.  PIN=512 clears threshold-regime LLR
accumulations while keeping bf16 rounding at the dead/live boundary
negligible (offset <= 3*PIN/2 between renorms, ULP(768)=4)."""

RENORM = 4
"""bf16 renormalisation cadence in trellis steps: path metrics must stay
O(branch metric) or the 8-bit mantissa rounds away the ACS margins."""

BLOCK = 256
"""Chains (window x codeblock pairs) per kernel program."""

NUM_WARPS = 4
"""Warps per kernel program (BLOCK / (32 * NUM_WARPS) chains per thread).
BLOCK and NUM_WARPS were chosen on an H100 (PERF.md)."""


@lru_cache(maxsize=None)
def _wiring():
    from lteax.phy.fec.turbo import _unrolled_wiring
    return _unrolled_wiring()


def _exact(x):
    return x


def _rounding(dt):
    """Per-operation rounding for the trellis arithmetic.  The kernel's
    bf16 operations round after every step by construction; XLA may keep
    fused bf16 chains in f32 (excess precision), so the XLA-lowered
    versions round explicitly to do the same arithmetic."""
    if dt != jnp.bfloat16:
        return _exact
    return lambda x: jax.lax.reduce_precision(x, exponent_bits=8,
                                              mantissa_bits=7)


def _gammas(uu, vv, rnd=_exact):
    gpp = rnd(0.5 * (uu + vv))
    gpm = rnd(0.5 * (uu - vv))
    return (gpp, gpm, -gpm, -gpp)


def _acs(m, g, wiring, rnd=_exact):
    """One radix-2 add-compare-select step over the 8 state metrics."""
    return tuple(rnd(jnp.maximum(m[p0] + g[g0], m[p1] + g[g1]))
                 for (p0, p1, g0, g1) in wiring)


def _renorm(a, b, rnd=_exact):
    return (tuple(rnd(x - a[0]) for x in a),
            tuple(rnd(x - b[0]) for x in b))


def _combine(a_s, b_s, uu, vv):
    """APP LLR at the position of ``a_s`` (``b_s`` = beta one step later).

    Branches are grouped by gamma code (bit-0 branches use codes {0,1},
    bit-1 codes {2,3}), hoisting the gamma add out of the per-branch sums.
    Arithmetic in f32: bf16 rounding in the combine costs whole turbo
    iterations near the decoding threshold."""
    _, _, out0, out1 = _wiring()
    f32 = jnp.float32
    g = _gammas(uu.astype(f32), vv.astype(f32))
    af = [x.astype(f32) for x in a_s]
    bf = [x.astype(f32) for x in b_s]
    m = [None] * 4
    for s in range(8):
        for ns, gc in (out0[s], out1[s]):
            t = af[s] + bf[ns]
            m[gc] = t if m[gc] is None else jnp.maximum(m[gc], t)
    l0 = jnp.maximum(m[0] + g[0], m[1] + g[1])
    l1 = jnp.maximum(m[2] + g[2], m[3] + g[3])
    return l0 - l1


def _live_masks(win: int, acq: int, n_w: int, n: int):
    """(win, n_w) / (acq, n_w) bool: trellis position is live (< n)."""
    pos_main = np.arange(win)[:, None] + win * np.arange(n_w)[None, :]
    pos_aacq = (np.arange(acq)[:, None] - acq
                + win * np.arange(n_w)[None, :])
    pos_bacq = (np.arange(acq)[:, None]
                + win * (np.arange(n_w)[None, :] + 1))
    return (pos_main < n, (pos_aacq >= 0) & (pos_aacq < n), pos_bacq < n)


def _check_geometry(win: int, acq: int, n: int, n_w: int):
    assert win % (2 * RENORM) == 0 and acq % RENORM == 0, (win, acq)
    assert 0 < acq <= win // 2 and n_w >= -(-n // win), (win, acq, n, n_w)


def _half_plain(um, vm, a_l, b_l, *, win: int, acq: int, n: int, dt):
    """Plain ``lax.scan`` half-iteration (same contract as the kernel;
    returns the un-shifted NII exports)."""
    fwd, bwd, _, _ = _wiring()
    rnd = _rounding(dt)
    n_w = um.shape[1]
    lv_main, lv_aacq, lv_bacq = _live_masks(win, acq, n_w, n)
    pad = jnp.asarray(np.where(lv_main, 0.0, PIN)[:, :, None], dt)
    um, vm = rnd(um), rnd(vm)

    # acquisition inputs: alpha reads the previous window's tail, beta the
    # next window's head (shift by one window along axis 1)
    def acq_slices(x):
        tail, head = x[win - acq:], x[:acq]
        zero = jnp.zeros_like(tail[:, :1])
        return (jnp.concatenate([zero, tail[:, :-1]], 1),
                jnp.concatenate([head[:, 1:], zero], 1))

    ua, ub = acq_slices(um)
    va, vb = acq_slices(vm)
    a = tuple(rnd(a_l[:, s, :].astype(dt)) for s in range(8))
    b = tuple(rnd(b_l[:, s, :].astype(dt)) for s in range(8))

    def acq_step(ab, xs):
        a, b = ab
        uat, vat, lat, ubt, vbt, lbt = xs
        a_new = _acs(a, _gammas(uat, vat, rnd), fwd, rnd)
        b_new = _acs(b, _gammas(ubt, vbt, rnd), bwd, rnd)
        return (tuple(jnp.where(lat, x, y) for x, y in zip(a_new, a)),
                tuple(jnp.where(lbt, x, y) for x, y in zip(b_new, b))), None

    (a, b), _ = jax.lax.scan(
        acq_step, (a, b),
        (ua, va, jnp.asarray(lv_aacq)[:, :, None],
         ub[::-1], vb[::-1], jnp.asarray(lv_bacq)[::-1, :, None]))

    # main sweeps: step t advances alpha over position t and beta over
    # position win-1-t; ys hold the pre-step metrics, renorm every RENORM
    def group(x):
        return x.reshape(win // RENORM, RENORM, *x.shape[1:])

    xs = tuple(map(group, (um, vm, rnd(um + pad)[::-1], vm[::-1])))

    def main_step(ab, xs_g):
        a, b = ab
        pre = []
        for h in range(RENORM):
            ut, vt, uj, vj = (x[h] for x in xs_g)
            pre.append((jnp.stack(a), jnp.stack(b)))
            a = _acs(a, _gammas(ut, vt, rnd), fwd, rnd)
            b = _acs(b, _gammas(uj, vj, rnd), bwd, rnd)
        if dt == jnp.bfloat16:
            a, b = _renorm(a, b, rnd)
        return (a, b), tuple(jnp.stack(p) for p in zip(*pre))

    _, (alphas, betas) = jax.lax.scan(main_step, (a, b), xs)
    alphas = alphas.reshape(win, 8, *um.shape[1:])     # alpha before pos t
    betas = betas.reshape(win, 8, *um.shape[1:])[::-1]  # beta after pos t
    l = _combine([alphas[:, s] for s in range(8)],
                 [betas[:, s] for s in range(8)], um, vm).astype(dt)
    # NII exports: alpha at (w+1)*win - acq, beta at w*win + acq
    return (l, alphas[win - acq].transpose(1, 0, 2).astype(jnp.float32),
            betas[acq - 1].transpose(1, 0, 2).astype(jnp.float32))


def _make_kernel(*, win: int, acq: int, n: int, dt, lane_blocks: int, rnd):
    """Pallas (Triton route) kernel body for one block of chains of one
    window; each chain's recursion runs in one thread.  ``rnd`` rounds each
    bf16 operation when the body is lowered by XLA (interpret mode);
    compiled for the GPU it is the identity."""
    fwd, bwd, _, _ = _wiring()
    half_w = win // 2
    bf16 = dt == jnp.bfloat16

    def kernel(u_ref, v_ref, up_ref, vp_ref, un_ref, vn_ref, ai_ref, bi_ref,
               l_ref, an_ref, bn_ref, as_ref, bs_ref):
        # u/v: this block's (win, block) metrics; up/vp: the previous
        # window's tail rows, un/vn: the next window's head rows
        w = pl.program_id(0) // lane_blocks

        def uv(t):
            return rnd(u_ref[t, :]), rnd(v_ref[t, :])

        def acs(m, uu, vv, wiring):
            return _acs(m, _gammas(uu, vv, rnd), wiring, rnd)

        def renorm(a, b):
            return _renorm(a, b, rnd) if bf16 else (a, b)

        a = tuple(rnd(ai_ref[0, s, :].astype(dt)) for s in range(8))
        b = tuple(rnd(bi_ref[0, s, :].astype(dt)) for s in range(8))

        # acquisition (the neighbour blocks are clamped at the ends, where
        # every position is dead)
        def acq_body(t, ab):
            a, b = ab
            pa = w * win - acq + t
            a_new = acs(a, rnd(up_ref[t, :]), rnd(vp_ref[t, :]), fwd)
            live_a = (pa >= 0) & (pa < n)
            a = tuple(jnp.where(live_a, x, y) for x, y in zip(a_new, a))
            j = acq - 1 - t
            b_new = acs(b, rnd(un_ref[j, :]), rnd(vn_ref[j, :]), bwd)
            live_b = (w + 1) * win + j < n
            b = tuple(jnp.where(live_b, x, y) for x, y in zip(b_new, b))
            return a, b

        a, b = jax.lax.fori_loop(0, acq, acq_body, (a, b))

        def beta_step(b, j, uj, vj):
            pad = (w * win + j >= n).astype(dt) * PIN
            return acs(b, rnd(uj + pad), vj, bwd)

        def store_body(q, ab):
            a, b = ab
            for h in range(RENORM):
                t = RENORM * q + h
                j = win - 1 - t
                for s in range(8):
                    as_ref[0, t, s, :] = a[s]
                    bs_ref[0, j - half_w, s, :] = b[s]
                a = acs(a, *uv(t), fwd)
                b = beta_step(b, j, *uv(j))
            return renorm(a, b)

        def comb_body(q, ab):
            a, b = ab
            for h in range(RENORM):
                t = RENORM * q + h
                j = win - 1 - t
                ut, vt = uv(t)
                uj, vj = uv(j)
                bs = [bs_ref[0, t - half_w, s, :] for s in range(8)]
                l_ref[t, :] = _combine(a, bs, ut, vt).astype(dt)
                as_ = [as_ref[0, j, s, :] for s in range(8)]
                l_ref[j, :] = _combine(as_, b, uj, vj).astype(dt)
                a = acs(a, ut, vt, fwd)
                b = beta_step(b, j, uj, vj)
            return renorm(a, b)

        a, b = jax.lax.fori_loop(0, half_w // RENORM, store_body, (a, b))
        a, b = jax.lax.fori_loop(half_w // RENORM, (win - acq) // RENORM,
                                 comb_body, (a, b))
        # NII exports at step win-acq: alpha at (w+1)*win - acq and beta
        # at w*win + acq, both pre-step
        for s in range(8):
            an_ref[0, s, :] = a[s].astype(jnp.float32)
            bn_ref[0, s, :] = b[s].astype(jnp.float32)
        jax.lax.fori_loop((win - acq) // RENORM, win // RENORM, comb_body,
                          (a, b))

    return kernel


def _half_kernel(um, vm, a_l, b_l, *, win: int, acq: int, n: int, dt,
                 block: int, num_warps: int, interpret: bool):
    """The Pallas kernel behind the half-iteration contract (returns the
    un-shifted NII exports).  Chains are flattened window-major and cut
    into blocks of ``block`` chains, so every program works on one window;
    its block specs also hand it the neighbouring windows' acquisition
    rows and one slot of the half-window alpha/beta scratch."""
    assert win % acq == 0, (win, acq)
    n_w, cpad = um.shape[1], um.shape[2]
    cp = -(-cpad // block) * block
    if cp != cpad:
        lane_pad = lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, cp - cpad)))
        um, vm, a_l, b_l = map(lane_pad, (um, vm, a_l, b_l))
    lane_blocks = cp // block
    n_blocks = n_w * lane_blocks
    kernel = _make_kernel(win=win, acq=acq, n=n, dt=dt,
                          lane_blocks=lane_blocks,
                          rnd=_rounding(dt) if interpret else _exact)
    f32 = jnp.float32
    rows = pl.BlockSpec((win, block), lambda i: (0, i))
    tail = pl.BlockSpec((acq, block), lambda i: (
        win // acq - 1, jnp.maximum(i - lane_blocks, 0)))
    head = pl.BlockSpec((acq, block), lambda i: (
        0, jnp.minimum(i + lane_blocks, n_blocks - 1)))
    state = pl.BlockSpec((1, 8, block), lambda i: (
        i // lane_blocks, 0, i % lane_blocks))
    store = pl.BlockSpec((1, win // 2, 8, block), lambda i: (i, 0, 0, 0))
    store_shape = jax.ShapeDtypeStruct((n_blocks, win // 2, 8, block), dt)
    u2, v2 = um.reshape(win, n_w * cp), vm.reshape(win, n_w * cp)
    l, a_nii, b_nii, _, _ = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[rows, rows, tail, tail, head, head, state, state],
        out_specs=[rows, state, state, store, store],
        out_shape=[jax.ShapeDtypeStruct((win, n_w * cp), dt),
                   jax.ShapeDtypeStruct((n_w, 8, cp), f32),
                   jax.ShapeDtypeStruct((n_w, 8, cp), f32),
                   store_shape, store_shape],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret,
        name="turbo_half_iteration",
    )(u2, v2, u2, v2, u2, v2, a_l, b_l)
    l = l.reshape(win, n_w, cp)
    if cp != cpad:
        l, a_nii, b_nii = l[..., :cpad], a_nii[..., :cpad], b_nii[..., :cpad]
    return l, a_nii, b_nii


@partial(jax.jit, static_argnames=("win", "acq", "n", "mdtype", "impl",
                                   "block", "num_warps"))
def half_iteration(um, vm, a_l, b_l, win: int, acq: int, n: int,
                   mdtype: str = "f32", impl: str = "auto",
                   block: int = BLOCK, num_warps: int = NUM_WARPS):
    """Max-log-MAP half-iteration over step-major operands.

    um/vm (win, n_w, cpad) channel metrics (u = systematic + a-priori,
    v = parity); a_l/b_l (n_w, 8, cpad) window-boundary inits, already
    pinned.  ``mdtype`` "f32" or "bf16" sets the trellis metric dtype.

    ``impl``: "auto" picks by the platform the call is lowered for — the
    Pallas kernel on CUDA, the plain scan elsewhere; "plain" and "kernel"
    force one; "interpret" runs the kernel in the Pallas interpreter.
    ``block``/``num_warps``: the kernel's launch shape.

    Returns (l (win, n_w, cpad) in the metric dtype, a_next, b_next
    (n_w, 8, cpad) f32 shifted into init position and normalised)."""
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[mdtype]
    _check_geometry(win, acq, n, um.shape[1])
    args = (um.astype(dt), vm.astype(dt), a_l.astype(jnp.float32),
            b_l.astype(jnp.float32))
    geo = dict(win=win, acq=acq, n=n, dt=dt)
    kern = partial(_half_kernel, **geo, block=block, num_warps=num_warps,
                   interpret=impl == "interpret")
    plain = partial(_half_plain, **geo)
    if impl == "auto":
        l, a_nii, b_nii = jax.lax.platform_dependent(*args, cuda=kern,
                                                     default=plain)
    else:
        l, a_nii, b_nii = (plain if impl == "plain" else kern)(*args)
    a_next = jnp.roll(a_nii, 1, axis=0)
    b_next = jnp.roll(b_nii, -1, axis=0)
    return (l, a_next - jnp.max(a_next, axis=1, keepdims=True),
            b_next - jnp.max(b_next, axis=1, keepdims=True))


def half_iteration_natural(u, v, a_init, b_init, win: int, acq: int, n: int,
                           mdtype: str = "f32", impl: str = "auto"):
    """Natural-layout entry: u, v (B, N); a_init/b_init (B, n_w, 8).

    Returns (L (B, N), a_next, b_next (B, n_w, 8)) with the NII convention
    of ``lteax.phy.fec.turbo._half_iteration``; a relayout onto
    :func:`half_iteration`."""
    bsz = u.shape[0]
    n_w = -(-n // win)
    pad = n_w * win - n

    def step_major(x):
        x = jnp.pad(x, ((0, 0), (0, pad)))
        return x.reshape(bsz, n_w, win).transpose(2, 1, 0)

    l, a_next, b_next = half_iteration(
        step_major(u), step_major(v), a_init.transpose(1, 2, 0),
        b_init.transpose(1, 2, 0), win, acq, n, mdtype=mdtype, impl=impl)
    l = l.transpose(2, 1, 0).reshape(bsz, n_w * win)[:, :n]
    return l, a_next.transpose(2, 0, 1), b_next.transpose(2, 0, 1)


# ---------------------------------------------------------------------------
# Layout-domain glue (production path)
#
# Every iteration-carried array stays in the kernel's step-major layout
# (win, n_w, C), and the QPP interleave is expressed as XLA gathers whose
# indices compose the permutation with the layout transform.  With C as the
# gather's offset (pass-through) dimension, each gather's output is born in
# kernel layout: no relayout copies between half-iterations.  Natural order
# is materialized once at the end.
# ---------------------------------------------------------------------------

class _BlaneMaps:
    """Precomputed numpy index maps for the step-major layout glue.

    Value at trellis position p = w*win + j of codeblock c lives at
    [j, w, c] of a (win, n_w, cpad) array.
    """

    def __init__(self, k: int, n: int, win: int, n_w: int, d_len: int,
                 crc: str | None):
        from lteax.phy.tables.turbo_qpp import qpp_interleaver, \
            qpp_deinterleaver
        self.k, self.n, self.win, self.n_w = k, n, win, n_w
        j = np.arange(win)
        w = np.arange(n_w)
        pos = w[None, :] * win + j[:, None]          # (win, n_w)
        live = pos < k
        pi = np.asarray(qpp_interleaver(k))
        inv = np.asarray(qpp_deinterleaver(k))

        def static(stream, tails, perm=None):
            """(win, n_w, 2) [stream, col] indices into (C, 3, d_len):
            the main stream (optionally ``perm``-interleaved) for p<k, the
            three tail-bit (stream, col) pairs at p=k..k+2, and a safe
            masked source for dead positions (zeroed via the m_n mask)."""
            smap = np.zeros(pos.shape, np.int64)
            cmap = np.zeros(pos.shape, np.int64)
            smap[live] = stream
            cmap[live] = pos[live] if perm is None else perm[pos[live]]
            for i, (s_t, c_t) in enumerate(tails):
                smap[pos == k + i] = s_t
                cmap[pos == k + i] = c_t
            return np.stack([smap, cmap], -1).astype(np.int32)

        # tail wiring == the sys_t/par_t stacks of the natural path
        self.u1s = static(0, [(0, k), (2, k), (1, k + 1)])
        self.v1s = static(1, [(1, k), (0, k + 1), (2, k + 1)])
        self.u2s = static(0, [(0, k + 2), (2, k + 2), (1, k + 3)], perm=pi)
        self.v2s = static(2, [(1, k + 2), (0, k + 3), (2, k + 3)])

        def chain(perm):
            """Layout->layout gather indices composing ``perm``."""
            p2 = np.zeros(pos.shape, np.int64)
            p2[live] = perm[pos[live]]
            return np.stack([p2 % win, p2 // win], -1).astype(np.int32)

        self.chain_pi = chain(pi)
        self.chain_inv = chain(inv)

        def nat(perm):
            """(k, 2) layout coords of natural position perm[i] (identity
            when perm is None)."""
            p2 = np.arange(k) if perm is None else perm[:k]
            return np.stack([p2 % win, p2 // win], -1).astype(np.int32)

        self.nat_id = nat(None)
        self.nat_inv = nat(inv)
        self.m01 = live.astype(np.float32)[:, :, None]     # extrinsic mask
        self.m_n = (pos < n).astype(np.float32)[:, :, None]  # static mask
        if crc is not None:
            from lteax.phy.fec.crc import crc_matrix
            m_nat = crc_matrix(k, crc)
            m_perm = m_nat[pi]                        # DEC2 (interleaved)
            r = m_perm.shape[1]
            ml = np.zeros((win, n_w, r), np.float32)
            ml[live] = m_perm[pos[live]]
            self.m_perm_flat = ml.reshape(win * n_w, r)
            mn = np.zeros((win, n_w, r), np.float32)
            mn[live] = m_nat[pos[live]]
            self.m_nat_flat = mn.reshape(win * n_w, r)


@lru_cache(maxsize=16)
def _blane_maps(k: int, n: int, win: int, n_w: int, d_len: int,
                crc: str | None) -> _BlaneMaps:
    return _BlaneMaps(k, n, win, n_w, d_len, crc)


_IN_BOUNDS = jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS


@lru_cache(maxsize=16)
def _planar_maps(k: int, n: int, win: int, n_w: int, d_len: int,
                 rm_key, n_cb: int, sentinel: int):
    """Static-gather maps for the PLANAR input form.

    ``rm_key`` is the (n_cb*3*d_len,) de-match index map into the planar
    LLR flat axis (sentinel = untransmitted position -> LLR 0).  Composes
    the rate de-match INTO the four layout static gathers, so the natural
    (C, 3, D) llr_d intermediate never materializes.

    Returns per-static idx (win, n_w, n_cb) int32 into the planar flat
    axis.  Untransmitted (sentinel) and dead trellis positions point at
    planar flat slot sentinel-1, which the pipeline guarantees reads 0.0
    (a pad column), so no mask multiply follows the gather.  Lane order of
    the gathered output is c' = cb*B + sf (cb-major) — callers reorder bits
    once at the end.
    """
    rm_inv = np.frombuffer(rm_key, dtype=np.int32).astype(np.int64)
    base = _blane_maps(k, n, win, n_w, d_len, None)
    pos = (np.arange(n_w)[None, :] * win + np.arange(win)[:, None])
    liven = (pos < n)

    out = {}
    for name in ("u1s", "v1s", "u2s", "v2s"):
        m2 = getattr(base, name).astype(np.int64)       # (win, n_w, 2)
        gidx = (np.arange(n_cb)[None, None, :] * 3 * d_len
                + m2[..., 0:1] * d_len + m2[..., 1:2])  # (win, n_w, n_cb)
        p = rm_inv[gidx]
        dead = (p == sentinel) | ~liven[..., None]
        out[name] = np.where(dead, sentinel - 1, p).astype(np.int32)
    # natural rebuild: per-cb (3*d_len,) planar indices
    g3 = (np.arange(n_cb)[:, None] * 3 * d_len + np.arange(3 * d_len))
    p3 = rm_inv[g3]
    out["cb_idx"] = np.where(p3 == sentinel, 0, p3).astype(np.int32)
    out["cb_w"] = (p3 != sentinel).astype(np.float32)
    return out


def _bl_static_planar(p2t, idx):
    """TRANSPOSED planar LLRs (planar_flat, B) -> (win, n_w, n_cb*B)
    layout, de-match and RE-extraction composed into the indices; B passes
    through as the gather's offset dim, so every gather point is one
    contiguous B-row read.  The chain runs 2D-flat (win*n_w*ncb, B); the
    final merge to (win, n_w, ncb*B) is a free bitcast."""
    win, n_w, ncb = idx.shape[:3]
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,),
        start_index_map=(0,))
    g = jax.lax.gather(p2t, jnp.asarray(idx).reshape(-1, 1), dn,
                       (1, p2t.shape[1]), mode=_IN_BOUNDS)
    return g.reshape(win, n_w, ncb * g.shape[1])


def _bl_static(llr3, idx):
    """(C, 3, d_len) LLRs -> (win, n_w, C) layout (C passes through as the
    gather's offset dim — the output is born in kernel layout).  The
    (stream, col) starts are pre-linearized into the row-major (3*d_len)
    flat axis."""
    c, _, d_len = llr3.shape
    idx = jnp.asarray(idx, jnp.int32)
    lin = idx[..., 0] * d_len + idx[..., 1]
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(2,), collapsed_slice_dims=(1,),
        start_index_map=(1,))
    return jax.lax.gather(llr3.reshape(c, 3 * d_len), lin[..., None], dn,
                          (c, 1), mode=_IN_BOUNDS)


def _bl_chain(x, idx):
    """Layout -> layout permuted gather (QPP composed into the indices);
    each point reads one contiguous C-row of the operand, indexed by its
    row in the row-major (win*n_w, C) view."""
    win, n_w, c = x.shape
    idx = jnp.asarray(idx, jnp.int32)
    lin = idx[..., 0] * n_w + idx[..., 1]
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(2,), collapsed_slice_dims=(0,),
        start_index_map=(0,))
    return jax.lax.gather(x.reshape(win * n_w, c), lin[..., None], dn,
                          (1, c), mode=_IN_BOUNDS)


def _bl_nat(x, idx, c: int):
    """Layout (win, n_w, cpad) -> (k, c) natural-position-major array
    (callers transpose in their consuming fusion)."""
    win, n_w, cp = x.shape
    idx = jnp.asarray(idx, jnp.int32)
    lin = idx[..., 0] * n_w + idx[..., 1]
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,),
        start_index_map=(0,))
    out = jax.lax.gather(x.reshape(win * n_w, cp), lin[..., None], dn,
                         (1, cp), mode=_IN_BOUNDS)
    return out[:, :c]


def _crc_par_blane(l2, m_flat):
    """Per-lane CRC pass/fail on a layout-domain LLR array (incl. pad
    lanes).  The CRC matrix rows are reordered into layout order
    (GF(2)-linear), so the contraction is one matmul over the flattened
    (j, w) axes: bf16 0/1 operands with f32 accumulation, exact for counts
    < 2^24 under any matmul precision."""
    win, n_w, cpad = l2.shape
    bits = (l2 < 0).astype(jnp.bfloat16).reshape(win * n_w, cpad)
    s = jax.lax.dot_general(jnp.asarray(m_flat, jnp.bfloat16), bits,
                            (((0,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    return jnp.all(jnp.mod(s, 2.0) == 0.0, axis=0)       # (cpad,)


def _crc_ok_blane(l2, m_flat, c: int):
    return _crc_par_blane(l2, m_flat)[:c]


def _pin_blane(a_l, b_l):
    """Pin window 0's alpha to the exact start state and the last window's
    beta to the exact termination state (window axis 0)."""
    pin = jnp.full((8,), NEG, jnp.float32).at[0].set(0.0)
    return a_l.at[0].set(pin[:, None]), b_l.at[-1].set(pin[:, None])


def _pin_boundaries(a_init, b_init):
    """Natural-layout _pin_blane (window axis 1)."""
    pin = jnp.full((8,), NEG, jnp.float32).at[0].set(0.0)
    a = a_init.at[:, 0, :].set(pin)
    b = b_init.at[:, -1, :].set(pin)
    return a, b


def turbo_decode_batch_pallas(llr_d, k: int, n_iter: int = 6, win: int = 128,
                              acq: int = 32, ext_scale: float = 0.75,
                              early_crc: str | None = None,
                              mdtype: str = "f32",
                              retry_m: int | None = None,
                              retry_levels: int | None = None,
                              layout: bool | None = None,
                              planar: tuple | None = None,
                              planar_int8: bool | None = None,
                              return_n_iter: bool = False,
                              impl: str = "auto",
                              interpret: bool = False):
    """Batched turbo decode on the half-iteration kernel.

    llr_d: (C, 3, K+4) -> (C, K) hard bits (int8).  Matches
    ``lteax.phy.fec.turbo.turbo_decode_batch`` numerically (same windowed
    max-log-MAP + NII schedule).

    early_crc ("24A"/"24B"/None): CRC-based early termination — stop
    iterating once EVERY codeblock's CRC checks (the standard production
    stopping rule).  Worst case (any failing block) runs all n_iter
    iterations, identical to early_crc=None; on convergent batches the
    remaining iterations are skipped batch-wide.

    layout (default on via DecoderTuning.layout_glue): run the full-batch
    iterations entirely in the kernel's step-major layout — the QPP
    interleave rides composed gathers (_BlaneMaps) and the per-iteration
    CRC runs as a layout-domain matmul.  Same max-log arithmetic; bf16
    rounding may differ in the last ulp of the extrinsic sums (u is
    pre-summed as static+extrinsic instead of subtracting twice).

    ``impl`` selects the half-iteration: "auto" (the kernel on CUDA, the
    plain scan elsewhere), "kernel" or "plain"; ``interpret`` runs the
    kernel in the Pallas interpreter (tests).
    """
    from lteax.phy.tables.turbo_qpp import qpp_interleaver, qpp_deinterleaver

    if (retry_m is None or retry_levels is None or layout is None
            or planar_int8 is None):
        from lteax.phy.tuning import DecoderTuning
        _t = DecoderTuning.from_env()
        retry_m = _t.retry_m if retry_m is None else retry_m
        retry_levels = _t.retry_levels if retry_levels is None else retry_levels
        layout = _t.layout_glue if layout is None else layout
        planar_int8 = _t.planar_int8 if planar_int8 is None else planar_int8
    impl = "interpret" if interpret else impl
    half = partial(half_iteration, win=win, acq=acq, n=k + 3, mdtype=mdtype,
                   impl=impl)
    if planar is not None:
        # (planar2 (B_sf, flat), rm_inv np.int32 (n_cb*3*d_len,), n_cb,
        # sentinel) — the de-match map into the planar demap output; the
        # four static gathers compose it (see _planar_maps)
        planar2, rm_inv_np, n_cb, sentinel = planar
        bsf = planar2.shape[0]
        c = n_cb * bsf
        d_len = k + 4
    else:
        c = llr_d.shape[0]
        d_len = llr_d.shape[2]
    n = k + 3
    n_w = -(-n // win)
    pi = jnp.asarray(qpp_interleaver(k))
    inv = jnp.asarray(qpp_deinterleaver(k))

    # extrinsic/l carries run in the metric dtype (bf16-safe: see _combine)
    dt_e = jnp.bfloat16 if mdtype == "bf16" else jnp.float32
    zero = jnp.zeros((c, n_w, 8), jnp.float32)

    def data_from(llr_sub):
        """Natural-path data tuple for a (sub)batch of flat LLR rows."""
        d0, d1, d2 = llr_sub[:, 0], llr_sub[:, 1], llr_sub[:, 2]
        ls = d0[:, :k]
        sys_t1 = jnp.stack([d0[:, k], d2[:, k], d1[:, k + 1]], axis=1)
        par_t1 = jnp.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], axis=1)
        sys_t2 = jnp.stack([d0[:, k + 2], d2[:, k + 2], d1[:, k + 3]], axis=1)
        par_t2 = jnp.stack([d1[:, k + 2], d0[:, k + 3], d2[:, k + 3]], axis=1)
        v1 = jnp.concatenate([d1[:, :k], par_t1], axis=1)
        v2 = jnp.concatenate([d2[:, :k], par_t2], axis=1)
        return (ls, ls[:, pi], v1, v2, sys_t1, sys_t2)

    def make_halves(data):
        """DEC1/DEC2 half-iteration closures over a (sub)batch's data
        (gathered rows of the full batch for the compacted retry pass)."""
        ls_, lsi_, v1_, v2_, st1_, st2_ = data

        def dec1(le21, a1, b1):
            u1 = jnp.concatenate([(ls_ + le21).astype(le21.dtype),
                                  st1_.astype(le21.dtype)], axis=1)
            a1p, b1p = _pin_boundaries(a1, b1)
            l1, a1n, b1n = half_iteration_natural(u1, v1_, a1p, b1p, win,
                                                  acq, n, mdtype=mdtype,
                                                  impl=impl)
            return l1[:, :k].astype(le21.dtype), a1n, b1n

        def ext12(l1, le21):
            return (ext_scale * (l1 - ls_ - le21)).astype(le21.dtype)

        def dec2(le12, a2, b2):
            la2 = le12[:, pi]
            u2 = jnp.concatenate([(lsi_ + la2).astype(le12.dtype),
                                  st2_.astype(le12.dtype)], axis=1)
            a2p, b2p = _pin_boundaries(a2, b2)
            l2, a2n, b2n = half_iteration_natural(u2, v2_, a2p, b2p, win,
                                                  acq, n, mdtype=mdtype,
                                                  impl=impl)
            l2 = l2[:, :k].astype(le12.dtype)
            le21n = (ext_scale * (l2 - lsi_ - la2)
                     ).astype(le12.dtype)[:, inv]
            return l2, le21n, a2n, b2n

        return dec1, dec2, ext12

    # ---- layout-domain path (see _BlaneMaps) ----
    use_layout = bool(layout) and (early_crc is None or 0 < retry_m < c)
    if planar is not None:
        pm = _planar_maps(k, n, win, n_w, d_len, rm_inv_np.tobytes(),
                          n_cb, sentinel)
        p2 = planar2.astype(dt_e)
        if not use_layout:
            # natural path: materialize llr_d (standard subframe-major
            # block order) from the planar input in one gather
            pm_idx = jnp.asarray(pm["cb_idx"])
            pm_w = jnp.asarray(pm["cb_w"], dt_e)
            vals = p2[:, pm_idx.reshape(-1)] * pm_w.reshape(-1)
            llr_d = vals.reshape(bsf, n_cb, 3, d_len).reshape(c, 3, d_len)
    if use_layout:
        maps = _blane_maps(k, n, win, n_w, d_len, early_crc)
        cpad = -(-c // BLOCK) * BLOCK
        m01 = jnp.asarray(maps.m01, dt_e)

        def _pad_lanes(g):
            if cpad != c:
                g = jnp.pad(g, ((0, 0), (0, 0), (0, cpad - c)))
            return g

        if planar is not None:
            p2t = p2.T        # one transpose; 4 contiguous-row gathers after
            qs_e = None
            if planar_int8:
                # int8-quantized statics: one per-batch scale, gathers move
                # half the bytes, the dequant multiply fuses into the
                # gather consumer.  The zero sentinel slot stays exactly
                # zero in int8; the uniform scale commutes through the
                # max-log decode up to quantization noise.
                p2f = planar2.astype(jnp.float32)
                qs = jnp.maximum(jnp.max(jnp.abs(p2f)), 1e-20) / 127.0
                p2t = jnp.clip(jnp.round(p2f.T / qs), -127,
                               127).astype(jnp.int8)
                qs_e = qs.astype(dt_e)

            def _mk_pl(name):
                g = _bl_static_planar(p2t, pm[name])
                if qs_e is not None:
                    g = g.astype(dt_e) * qs_e
                return _pad_lanes(g)

            u1s, v1l, u2s, v2l = map(_mk_pl, ("u1s", "v1s", "u2s", "v2s"))
        else:
            llr3 = llr_d.astype(dt_e)
            m_n = jnp.asarray(maps.m_n, dt_e)

            def mk_static(idx):
                return _pad_lanes(_bl_static(llr3, idx) * m_n)

            u1s, v1l, u2s, v2l = map(mk_static, (maps.u1s, maps.v1s,
                                                 maps.u2s, maps.v2s))

        def one_iteration_l(le21_l, a1, b1, a2, b2):
            u1 = u1s + m01 * le21_l
            l1, a1n, b1n = half(u1, v1l, *_pin_blane(a1, b1))
            e12 = ext_scale * (l1.astype(dt_e) - u1)
            u2 = u2s + m01 * _bl_chain(e12, maps.chain_pi)
            l2, a2n, b2n = half(u2, v2l, *_pin_blane(a2, b2))
            le21n = _bl_chain(ext_scale * (l2.astype(dt_e) - u2),
                              maps.chain_inv)
            return le21n, a1n, b1n, a2n, b2n, l2

        zero_l = jnp.zeros((win, n_w, cpad), dt_e)
        zero_ab = jnp.zeros((n_w, 8, cpad), jnp.float32)
        init_l = (zero_l, zero_ab, zero_ab, zero_ab, zero_ab)

        def bits_std(bits_cp):
            """Lane-order bits -> standard subframe-major block order (the
            planar statics' lanes are cb-major: c' = cb*B + sf)."""
            if planar is None:
                return bits_cp
            return (bits_cp.reshape(n_cb, bsf, k)
                    .transpose(1, 0, 2).reshape(c, k))

        def bits_nat(l2):
            return ((_bl_nat(l2, maps.nat_inv, c) < 0).T).astype(jnp.int8)

        if early_crc is None:
            def body(carry, _):
                st, _ = carry
                out = one_iteration_l(*st)
                return (out[:5], out[5]), None
            (_, l2), _ = jax.lax.scan(body, (init_l, zero_l), None,
                                      length=n_iter)
            bits = bits_std(bits_nat(l2))
            return (bits, jnp.int32(n_iter)) if return_n_iter else bits

        m_perm_flat = maps.m_perm_flat

    from lteax.phy.fec.crc import crc_matrix

    # Half-iteration early stop.  The CRC is checked after EACH decoder
    # half: DEC1's APP LLR is in natural bit order (contribution matrix M),
    # DEC2's in the interleaved domain (row-permuted M[pi] — CRC is
    # GF(2)-linear, a codeword is g(x)-divisible iff its full-length CRC is
    # zero).  When every codeblock already passes after DEC1, the DEC2 half
    # (kernel + QPP gathers) is skipped via lax.cond; worst case matches
    # the fixed-n_iter schedule plus the checks.
    if early_crc is not None:
        m_nat = jnp.asarray(crc_matrix(k, early_crc), dtype=jnp.int32)
        m_perm = jnp.asarray(crc_matrix(k, early_crc)[np.asarray(
            qpp_interleaver(k))], dtype=jnp.int32)

    def run_earlystop(data, state, iters_left, ignore=None):
        """Early-stopping decode of a (sub)batch from a carried state.

        ``ignore`` (bool (c,), optional) marks blocks whose CRC outcome is
        irrelevant to the stop condition (the compacted retry pads its
        subbatch with already-converged blocks — their transient DEC1
        re-check failures must not delay the stop).
        Returns (bits_natural (c,K) int8, full_iterations_used)."""
        dec1, dec2, ext12 = make_halves(data)

        def _allok(blockok):
            return jnp.all(blockok if ignore is None
                           else jnp.logical_or(blockok, ignore))

        def cond(carry):
            it, done = carry[0], carry[1]
            return jnp.logical_and(it < iters_left, jnp.logical_not(done))

        def body(carry):
            it, _, _, le21, a1, b1, a2, b2, _ = carry
            l1, a1n, b1n = dec1(le21, a1, b1)
            ok1 = _allok(jnp.all(
                ((l1 < 0).astype(jnp.int32) @ m_nat) % 2 == 0, axis=-1))

            def do_dec2(_):
                l2, le21n, a2n, b2n = dec2(ext12(l1, le21), a2, b2)
                ok2 = _allok(jnp.all(
                    ((l2 < 0).astype(jnp.int32) @ m_perm) % 2 == 0, axis=-1))
                return (le21n, a2n, b2n, l2, ok2, jnp.bool_(False))

            def skip_dec2(_):
                return (le21, a2, b2, l1, jnp.bool_(True), jnp.bool_(True))

            le21n, a2n, b2n, llast, done, from1 = jax.lax.cond(
                ok1, skip_dec2, do_dec2, None)
            return (it + 1, done, from1, le21n, a1n, b1n, a2n, b2n, llast)

        carry = (jnp.int32(0), jnp.bool_(False), jnp.bool_(False), *state,
                 jnp.zeros((data[0].shape[0], k), dt_e))
        carry = jax.lax.while_loop(cond, body, carry)
        llast, from1 = carry[-1], carry[2]
        bits_raw = (llast < 0).astype(jnp.int8)
        # llast is natural-order when the loop stopped after DEC1,
        # interleaved when it ran (or ended at) DEC2
        bits = jnp.where(from1, bits_raw, bits_raw[:, inv])
        return bits, carry[0]

    if use_layout:
        # ---- layout-native multi-level compacted retry ----
        # The retry subbatch is a lane-slice of the already-materialized
        # layout statics and carried state — no natural-order rebuild and
        # no planar/llr_d captures inside the conditional branches.
        chain_pi_j = jnp.asarray(maps.chain_pi)
        chain_inv_j = jnp.asarray(maps.chain_inv)
        nat_id_j = jnp.asarray(maps.nat_id)
        nat_inv_j = jnp.asarray(maps.nat_inv)
        m_nat_flat = maps.m_nat_flat

        def run_earlystop_l(subs, state, iters_left, ignore_ok):
            """Layout-domain early-stopping decode of a lane set.

            subs = (u1s, v1, u2s, v2) lane-sliced statics; state the
            matching lane-sliced carry; ``ignore_ok`` (lanes,) bool marks
            pad/already-converged lanes whose CRC must not delay the stop.
            Same half-iteration CRC-skip schedule as the natural
            ``run_earlystop``.  Returns (bits (lanes, K) int8 in lane
            order, full_iterations_used)."""
            u1s_s, v1_s, u2s_s, v2_s = subs
            lanes = u1s_s.shape[2]

            def _allok(par):
                return jnp.all(jnp.logical_or(par, ignore_ok))

            def cond(carry):
                it, done = carry[0], carry[1]
                return jnp.logical_and(it < iters_left,
                                       jnp.logical_not(done))

            def body(carry):
                it, _, _, le21, a1, b1, a2, b2, _ = carry
                u1 = u1s_s + m01 * le21
                l1, a1n, b1n = half(u1, v1_s, *_pin_blane(a1, b1))
                ok1 = _allok(_crc_par_blane(l1, m_nat_flat))

                def do_dec2(_):
                    e12 = ext_scale * (l1.astype(dt_e) - u1)
                    u2 = u2s_s + m01 * _bl_chain(e12, chain_pi_j)
                    l2, a2n, b2n = half(u2, v2_s, *_pin_blane(a2, b2))
                    ok2 = _allok(_crc_par_blane(l2, m_perm_flat))
                    le21n = _bl_chain(ext_scale * (l2.astype(dt_e) - u2),
                                      chain_inv_j)
                    return (le21n, a2n, b2n, l2.astype(dt_e), ok2,
                            jnp.bool_(False))

                def skip_dec2(_):
                    return (le21, a2, b2, l1.astype(dt_e), jnp.bool_(True),
                            jnp.bool_(True))

                le21n, a2n, b2n, llast, done, from1 = jax.lax.cond(
                    ok1, skip_dec2, do_dec2, None)
                return (it + 1, done, from1, le21n, a1n, b1n, a2n, b2n,
                        llast)

            carry = (jnp.int32(0), jnp.bool_(False), jnp.bool_(False),
                     *state, jnp.zeros_like(state[0]))
            carry = jax.lax.while_loop(cond, body, carry)
            llast, from1 = carry[-1], carry[2]
            # llast is natural-domain when the loop stopped after DEC1,
            # interleaved when it ran DEC2 — select the index map (static
            # constants; jnp.where keeps the gather single)
            sel = jnp.where(from1, nat_id_j, nat_inv_j)
            bits = ((_bl_nat(llast, sel, lanes) < 0).T).astype(jnp.int8)
            return bits, carry[0]

        statics = (u1s, v1l, u2s, v2l)
        ign_pad = jnp.asarray(np.arange(cpad) >= c)

        def compact_at_l(kk, state_k, bits_k, okb_k, n_fail_k):
            tlr = -(-retry_m // BLOCK) * BLOCK
            idx = jnp.argsort(okb_k)[:retry_m]        # failing blocks first
            idxp = jnp.pad(idx, (0, tlr - retry_m))
            subs = tuple(jnp.take(x, idxp, axis=-1) for x in statics)
            sub_state = tuple(jnp.take(x, idxp, axis=-1) for x in state_k)
            ign = jnp.pad(okb_k[idx], (0, tlr - retry_m),
                          constant_values=True)
            sub_bits, sub_it = run_earlystop_l(
                subs, sub_state,
                jnp.where(n_fail_k == 0, 0, n_iter - kk), ign)
            take_new = jnp.logical_not(okb_k[idx])[:, None]
            merged = jnp.where(take_new, sub_bits[:retry_m], bits_k[idx])
            return bits_k.at[idx].set(merged), sub_it

        def level_l(kk, state_k, bits_k, okb_k):
            n_fail_k = jnp.sum(jnp.logical_not(okb_k))

            def compact(_):
                return compact_at_l(kk, state_k, bits_k, okb_k, n_fail_k)

            if kk >= min(retry_levels, n_iter - 1):
                def full(_):
                    bits_f, it_f = run_earlystop_l(
                        statics, state_k, n_iter - kk, ign_pad)
                    return bits_f[:c], it_f
                return jax.lax.cond(n_fail_k <= retry_m, compact, full,
                                    None)

            def deeper(_):
                le21n, a1n, b1n, a2n, b2n, l2n = one_iteration_l(*state_k)
                okb_n = _crc_ok_blane(l2n, m_perm_flat, c)
                inner_bits, inner_it = level_l(
                    kk + 1, (le21n, a1n, b1n, a2n, b2n), bits_nat(l2n),
                    okb_n)
                return inner_bits, inner_it + 1

            return jax.lax.cond(n_fail_k <= retry_m, compact, deeper, None)

        le21_l, a1n, b1n, a2n, b2n, l2 = one_iteration_l(*init_l)
        okb = _crc_ok_blane(l2, m_perm_flat, c)
        bits, extra_it = level_l(1, (le21_l, a1n, b1n, a2n, b2n),
                                 bits_nat(l2), okb)
        bits = bits_std(bits)
        return (bits, 1 + extra_it) if return_n_iter else bits

    # ---- natural-order path (layout off, retry off, or tiny batches) ----
    data_full = data_from(llr_d)

    def one_iteration(le21, a1, b1, a2, b2):
        dec1, dec2, ext12 = make_halves(data_full)
        l1, a1n, b1n = dec1(le21, a1, b1)
        # l2 stays in DEC2's interleaved domain: the final check permutes
        # the CRC contribution matrix instead (GF(2)-linear), and the single
        # deinterleave gather happens once after the iteration loop
        l2, le21n, a2n, b2n = dec2(ext12(l1, le21), a2, b2)
        return le21n, a1n, b1n, a2n, b2n, l2

    init = (jnp.zeros((c, k), dt_e), zero, zero, zero, zero)

    if early_crc is None:
        def body(carry, _):
            out = one_iteration(*carry)
            return out[:5], out[5]
        _, l_hist = jax.lax.scan(body, init, None, length=n_iter)
        bits = (l_hist[-1][:, inv] < 0).astype(jnp.int8)
        return (bits, jnp.int32(n_iter)) if return_n_iter else bits

    if not (0 < retry_m < c):
        bits, iters = run_earlystop(data_full, init, n_iter)
        return (bits, iters) if return_n_iter else bits

    # ---- multi-level compacted retry ----
    # One full iteration for the whole batch, then ONLY the codeblocks that
    # still fail CRC keep iterating, gathered into a retry_m-block subbatch
    # (at comfortable margins a handful of stragglers out of thousands
    # would otherwise force a whole extra batch-wide iteration).  When MORE
    # than retry_m blocks fail (threshold regime), run ANOTHER full-batch
    # iteration and check again, up to ``retry_levels`` full iterations;
    # beyond that, fall back to the full-batch early-stop loop.
    def compact_at(kk, state_k, bits_k, okb_k, n_fail_k):
        """Gather the (<= retry_m) failing blocks and finish them alone."""
        idx = jnp.argsort(okb_k)[:retry_m]        # failing blocks first
        sub_data = tuple(x[idx] for x in data_full)
        sub_state = tuple(x[idx] for x in state_k)
        sub_bits, sub_it = run_earlystop(
            sub_data, sub_state,
            jnp.where(n_fail_k == 0, 0, n_iter - kk), ignore=okb_k[idx])
        # keep the full-batch bits for blocks that were already ok (the
        # retry subbatch is padded with ok blocks when fewer than retry_m
        # failed; their re-decode is equivalent but not replayed)
        take_new = jnp.logical_not(okb_k[idx])[:, None]
        merged = jnp.where(take_new, sub_bits, bits_k[idx])
        return bits_k.at[idx].set(merged), sub_it

    def level(kk, state_k, bits_k, okb_k):
        """kk full iterations done; decide compact / deeper / full."""
        n_fail_k = jnp.sum(jnp.logical_not(okb_k))

        def compact(_):
            return compact_at(kk, state_k, bits_k, okb_k, n_fail_k)

        if kk >= min(retry_levels, n_iter - 1):
            def full(_):
                return run_earlystop(data_full, state_k, n_iter - kk)
            return jax.lax.cond(n_fail_k <= retry_m, compact, full, None)

        def deeper(_):
            le21n, a1n, b1n, a2n, b2n, l2n = one_iteration(*state_k)
            okb_n = jnp.all(
                ((l2n < 0).astype(jnp.int32) @ m_perm) % 2 == 0, axis=-1)
            bits_n = (l2n < 0).astype(jnp.int8)[:, inv]
            inner_bits, inner_it = level(
                kk + 1, (le21n, a1n, b1n, a2n, b2n), bits_n, okb_n)
            return inner_bits, inner_it + 1

        return jax.lax.cond(n_fail_k <= retry_m, compact, deeper, None)

    le21, a1n, b1n, a2n, b2n, l2 = one_iteration(*init)
    okb = jnp.all(((l2 < 0).astype(jnp.int32) @ m_perm) % 2 == 0, axis=-1)
    bits_a = (l2 < 0).astype(jnp.int8)[:, inv]
    bits, extra_it = level(1, (le21, a1n, b1n, a2n, b2n), bits_a, okb)
    return (bits, 1 + extra_it) if return_n_iter else bits
