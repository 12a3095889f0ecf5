"""Turbo half-iteration (kernels/turbo_mlm.py): the Pallas kernel in
interpret mode and the plain scan against each other and against the XLA
reference decoder; the wrapper's padding and choice of implementation; the
compiled kernel on the GPU (``gpu`` marker)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lteax.phy.fec.turbo import (_half_iteration, turbo_encode_batch,
                                 turbo_decode_batch)
from lteax.kernels import turbo_mlm
from lteax.kernels.turbo_mlm import turbo_decode_batch_pallas


def _noisy_llr(rng, c, k, sigma=0.65, scale=1.0):
    bits = rng.integers(0, 2, size=(c, k)).astype(np.int32)
    d = np.asarray(turbo_encode_batch(jnp.asarray(bits), k)).astype(np.float32)
    rx = (1.0 - 2.0 * d) + sigma * rng.standard_normal(d.shape).astype(np.float32)
    return bits, jnp.asarray(scale * 2.0 * rx / sigma**2)


def _half_inputs(rng, bsz, k, win=128):
    n = k + 3
    n_w = -(-n // win)
    u = jnp.asarray(3 * rng.standard_normal((bsz, n)).astype(np.float32))
    v = jnp.asarray(3 * rng.standard_normal((bsz, n)).astype(np.float32))
    a0 = jnp.asarray(rng.standard_normal((bsz, n_w, 8)).astype(np.float32))
    b0 = jnp.asarray(rng.standard_normal((bsz, n_w, 8)).astype(np.float32))
    return (u, v, *turbo_mlm._pin_boundaries(a0, b0))


@pytest.mark.parametrize(
    "k", [40, 232, pytest.param(1024, marks=pytest.mark.mid)])
def test_pallas_matches_xla_noisy(k):
    rng = np.random.default_rng(0)
    bits, llr = _noisy_llr(rng, 4, k)
    ref = np.asarray(turbo_decode_batch(llr, k, n_iter=4))
    got = np.asarray(turbo_decode_batch_pallas(llr, k, n_iter=4,
                                               interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ref, bits)  # and both are correct


def test_pallas_high_rate():
    from lteax.phy.fec.ratematch import turbo_rm_indices, rate_match, rate_unmatch
    rng = np.random.default_rng(3)
    k = 1056
    e_len = int(k / 0.85)
    idx = turbo_rm_indices(k + 4, e_len, rv=0)
    bits = rng.integers(0, 2, size=(2, k)).astype(np.int32)
    d = turbo_encode_batch(jnp.asarray(bits), k)
    e = np.asarray(rate_match(d, idx)).astype(np.float32)
    sigma = float(np.sqrt(1.0 / (2 * 10 ** (2.0))))  # 20 dB
    rx = (1.0 - 2.0 * e) + sigma * rng.standard_normal(e.shape).astype(np.float32)
    llr = rate_unmatch(jnp.asarray(2.0 * rx / sigma**2), idx, k + 4)
    got = np.asarray(turbo_decode_batch_pallas(llr, k, n_iter=6,
                                               interpret=True))
    np.testing.assert_array_equal(got, bits)


def test_early_crc_termination():
    """early_crc stopping returns CRC-valid bits (identical payloads) and
    degrades to the full-iteration decode on garbage input."""
    from lteax.phy.fec.crc import attach_crc, check_crc
    rng = np.random.default_rng(11)
    k, c = 232, 4
    payload = rng.integers(0, 2, size=(c, k - 24)).astype(np.int32)
    bits = np.asarray(attach_crc(jnp.asarray(payload), "24B"))
    d = np.asarray(turbo_encode_batch(jnp.asarray(bits), k)).astype(np.float32)
    sigma = 0.6
    rx = (1.0 - 2.0 * d) + sigma * rng.standard_normal(d.shape).astype(np.float32)
    llr = jnp.asarray(2.0 * rx / sigma**2)
    got = np.asarray(turbo_decode_batch_pallas(llr, k, n_iter=6,
                                               early_crc="24B",
                                               interpret=True))
    pay, ok = check_crc(jnp.asarray(got), "24B")
    assert np.all(np.asarray(ok))
    np.testing.assert_array_equal(np.asarray(pay), payload)
    # garbage input: must not hang/crash, CRC simply fails
    garbage = jnp.asarray(rng.standard_normal(llr.shape).astype(np.float32))
    got2 = turbo_decode_batch_pallas(garbage, k, n_iter=2, early_crc="24B",
                                     interpret=True)
    _, ok2 = check_crc(got2, "24B")
    assert not np.all(np.asarray(ok2))


@pytest.mark.mid
def test_pallas_bf16_decodes():
    """bf16 trellis path (with per-block renormalisation) decodes cleanly at
    bench-scale LLR magnitudes."""
    rng = np.random.default_rng(7)
    bits, llr = _noisy_llr(rng, 4, 1024, scale=500.0)
    got = np.asarray(turbo_decode_batch_pallas(llr, 1024, n_iter=4,
                                               mdtype="bf16", interpret=True))
    np.testing.assert_array_equal(got, bits)


@pytest.mark.mid
def test_fused_decode_bf16():
    rng = np.random.default_rng(8)
    bits, llr = _noisy_llr(rng, 3, 5824, sigma=0.6)
    got = np.asarray(turbo_decode_batch_pallas(llr, 5824, n_iter=4, acq=16,
                                               mdtype="bf16", interpret=True))
    np.testing.assert_array_equal(got, bits)


@pytest.mark.parametrize("mdtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [40, 1024, 5824])
def test_plain_half_iteration_matches_reference(k, mdtype):
    """The plain scan half-iteration against phy/fec/turbo._half_iteration
    (freeze-masked, ungrouped combine, f32).  f32: the pinned padding
    accumulates u=+PIN over dead positions without renormalisation, so
    the beta metrics near the trellis end sit near 128*PIN/2 and carry f32
    rounding of that magnitude (~2e-3).  bf16: every metric rounds to an
    8-bit mantissa at each step, so L carries errors of a few percent of
    its scale (measured mean ~1%, max ~14%); hard decisions must agree
    wherever |L| is at least a tenth of its scale."""
    rng = np.random.default_rng(k)
    win, acq, n = 128, 16, k + 3
    u, v, a0, b0 = _half_inputs(rng, 3, k)
    got = turbo_mlm.half_iteration_natural(u, v, a0, b0, win, acq, n,
                                           mdtype=mdtype, impl="plain")
    ref_l, (ref_a, ref_b) = jax.vmap(
        lambda uu, vv, aa, bb: _half_iteration(uu, vv, win, acq, (aa, bb)))(
        u, v, a0, b0)
    l, ref_l = np.asarray(got[0], np.float32), np.asarray(ref_l)
    scale = float(np.abs(ref_l).max())
    if mdtype == "f32":
        np.testing.assert_allclose(l, ref_l, rtol=0, atol=2e-2)
        # NII exports of windows seeded from inside the trellis (window 0's
        # alpha and the betas seeded past the end carry the start /
        # termination pin, exact in the reference, PIN-margined here)
        inside = (np.arange(ref_a.shape[1]) + 1) * win + acq <= n
        np.testing.assert_allclose(np.asarray(got[1])[:, 1:],
                                   np.asarray(ref_a)[:, 1:], atol=2e-2)
        np.testing.assert_allclose(np.asarray(got[2])[:, inside],
                                   np.asarray(ref_b)[:, inside], atol=2e-2)
    else:
        confident = np.abs(ref_l) > 0.1 * scale
        np.testing.assert_array_equal((l < 0)[confident],
                                      (ref_l < 0)[confident])
        err = np.abs(l - ref_l)
        assert err.mean() <= 0.02 * scale and err.max() <= 0.2 * scale


@pytest.mark.parametrize("mdtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [40, 1024, 5824])
def test_kernel_interpret_matches_plain(k, mdtype):
    """The kernel body (Pallas interpreter) does the plain scan's arithmetic
    bit for bit; a small block keeps the interpreter fast."""
    rng = np.random.default_rng(100 + k)
    win, acq, n = 128, 16, k + 3
    n_w = -(-n // win)
    c = 5
    um = jnp.asarray(3 * rng.standard_normal((win, n_w, c)), jnp.float32)
    vm = jnp.asarray(3 * rng.standard_normal((win, n_w, c)), jnp.float32)
    a_l, b_l = turbo_mlm._pin_blane(
        jnp.asarray(rng.standard_normal((n_w, 8, c)), jnp.float32),
        jnp.asarray(rng.standard_normal((n_w, 8, c)), jnp.float32))
    plain = turbo_mlm.half_iteration(um, vm, a_l, b_l, win, acq, n,
                                     mdtype=mdtype, impl="plain")
    kern = turbo_mlm.half_iteration(um, vm, a_l, b_l, win, acq, n,
                                    mdtype=mdtype, impl="interpret",
                                    block=8, num_warps=1)
    for p, q in zip(plain, kern):
        np.testing.assert_array_equal(np.asarray(p, np.float32),
                                      np.asarray(q, np.float32))


@pytest.mark.parametrize("cpad,extra_windows", [(3, 0), (13, 2)])
def test_kernel_wrapper_pads_lanes_and_windows(cpad, extra_windows):
    """Lane counts that are not a multiple of the block are padded and
    sliced back; surplus (fully dead) windows are allowed."""
    rng = np.random.default_rng(cpad)
    win, acq, k = 32, 8, 104
    n = k + 3
    n_w = -(-n // win) + extra_windows
    um = jnp.asarray(3 * rng.standard_normal((win, n_w, cpad)), jnp.float32)
    vm = jnp.asarray(3 * rng.standard_normal((win, n_w, cpad)), jnp.float32)
    a_l, b_l = turbo_mlm._pin_blane(jnp.zeros((n_w, 8, cpad)),
                                    jnp.zeros((n_w, 8, cpad)))
    plain = turbo_mlm.half_iteration(um, vm, a_l, b_l, win, acq, n,
                                     impl="plain")
    kern = turbo_mlm.half_iteration(um, vm, a_l, b_l, win, acq, n,
                                    impl="interpret", block=8, num_warps=1)
    for p, q in zip(plain, kern):
        assert p.shape == q.shape
        np.testing.assert_array_equal(np.asarray(p), np.asarray(q))


@pytest.mark.parametrize("platform,kernel", [("cpu", False), ("cuda", True)])
def test_implementation_follows_lowering_platform(platform, kernel):
    """impl=None lowers the Triton kernel for CUDA and the plain scan
    elsewhere (cross-lowered here, no GPU needed)."""
    win, acq, k = 32, 8, 104
    n = k + 3
    n_w = -(-n // win)
    um = jax.ShapeDtypeStruct((win, n_w, 256), jnp.float32)
    ab = jax.ShapeDtypeStruct((n_w, 8, 256), jnp.float32)
    f = jax.jit(lambda a, b, c, d: turbo_mlm.half_iteration(
        a, b, c, d, win, acq, n, mdtype="bf16"))
    text = f.trace(um, um, ab, ab).lower(
        lowering_platforms=(platform,)).as_text()
    assert ("__gpu$xla.gpu.triton" in text) == kernel


def test_interpret_flag_runs_the_kernel():
    """turbo_decode_batch_pallas(interpret=True) decodes through the kernel
    in the interpreter, impl="plain" through the scan: same bits."""
    rng = np.random.default_rng(21)
    bits, llr = _noisy_llr(rng, 3, 104)
    got = [np.asarray(turbo_decode_batch_pallas(
        llr, 104, n_iter=3, win=32, acq=8, **kw))
        for kw in (dict(interpret=True), dict(impl="plain"))]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], bits)


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_on_gpu():
    """The Triton-compiled kernel against the plain scan at DL width, f32
    and bf16 (chip_smoke.py phase 2 at 512 codeblocks)."""
    import chip_smoke
    chip_smoke.phase_turbo(c=512, reps=1)
