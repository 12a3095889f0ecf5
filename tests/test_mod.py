"""Modulation mapper anchors from the 36.211 §7.1 tables + demapper sanity."""

import numpy as np
import pytest
import jax.numpy as jnp

from lteax.phy.mod import constellation, modulate, demodulate_maxlog


def test_qpsk_table_anchors():
    t = constellation("qpsk")
    s2 = np.sqrt(2)
    np.testing.assert_allclose(t[0b00], (1 + 1j) / s2, rtol=1e-6)
    np.testing.assert_allclose(t[0b01], (1 - 1j) / s2, rtol=1e-6)
    np.testing.assert_allclose(t[0b10], (-1 + 1j) / s2, rtol=1e-6)
    np.testing.assert_allclose(t[0b11], (-1 - 1j) / s2, rtol=1e-6)


def test_16qam_table_anchors():
    t = constellation("16qam")
    s10 = np.sqrt(10)
    np.testing.assert_allclose(t[0b0000], (1 + 1j) / s10, rtol=1e-6)
    np.testing.assert_allclose(t[0b0010], (3 + 1j) / s10, rtol=1e-6)
    np.testing.assert_allclose(t[0b0001], (1 + 3j) / s10, rtol=1e-6)
    np.testing.assert_allclose(t[0b1011], (-3 + 3j) / s10, rtol=1e-6)
    np.testing.assert_allclose(t[0b1111], (-3 - 3j) / s10, rtol=1e-6)


def test_64qam_table_anchors():
    t = constellation("64qam")
    s42 = np.sqrt(42)
    np.testing.assert_allclose(t[0b000000], (3 + 3j) / s42, rtol=1e-6)
    np.testing.assert_allclose(t[0b000100], (3 + 5j) / s42, rtol=1e-6)
    np.testing.assert_allclose(t[0b100000], (-3 + 3j) / s42, rtol=1e-6)
    np.testing.assert_allclose(t[0b101110], (-7 + 5j) / s42, rtol=1e-6)
    np.testing.assert_allclose(t[0b111111], (-7 - 7j) / s42, rtol=1e-6)


def test_unit_average_power():
    for scheme in ("bpsk", "qpsk", "16qam", "64qam"):
        t = constellation(scheme)
        assert abs(np.mean(np.abs(t) ** 2) - 1.0) < 1e-6, scheme


def test_per_axis_demap_matches_full_constellation():
    """The factorized PAM demap must equal the generic 2D subset-min demap
    (the free-axis min cancels in the LLR difference)."""
    from lteax.phy.mod import _subset_min_llr, _bit_masks, BITS_PER_SYM

    rng = np.random.default_rng(7)
    y = jnp.asarray((rng.standard_normal(500)
                     + 1j * rng.standard_normal(500)).astype(np.complex64))
    nv = jnp.asarray(0.3 + rng.random(500).astype(np.float32))
    for scheme in ("qpsk", "16qam", "64qam"):
        fast = demodulate_maxlog(y, scheme, nv)
        full = _subset_min_llr(y, jnp.asarray(constellation(scheme)),
                               jnp.asarray(_bit_masks(scheme)))
        full = (full / nv[..., None]).reshape(-1)
        np.testing.assert_allclose(np.asarray(fast), np.asarray(full),
                                   rtol=2e-4, atol=2e-5, err_msg=scheme)
        m = BITS_PER_SYM[scheme]
        assert fast.shape == (500 * m,)


def test_llr_magnitude_scales_with_noise():
    rng = np.random.default_rng(0)
    bits = jnp.asarray(rng.integers(0, 2, size=600).astype(np.int32))
    s = modulate(bits, "64qam")
    l_low = demodulate_maxlog(s, "64qam", noise_var=0.1)
    l_high = demodulate_maxlog(s, "64qam", noise_var=0.01)
    np.testing.assert_allclose(np.asarray(l_high), 10 * np.asarray(l_low),
                               rtol=1e-4)
    # hard decisions correct in both cases
    assert ((np.asarray(l_low) < 0).astype(int) == np.asarray(bits)).all()


@pytest.mark.parametrize("scheme", ["qpsk", "16qam", "64qam"])
def test_demap_planar_matches_demodulate_maxlog(scheme):
    """The planar demap (the production fronts' LLR + descramble) equals
    demodulate_maxlog times the scrambling sign, with plane j holding bit j
    of each symbol, and emits exact zeros past the symbols."""
    from lteax.phy.mod import (BITS_PER_SYM, demap_planar,
                               demodulate_maxlog, planar_sgn_np)
    rng = np.random.default_rng(5)
    m = BITS_PER_SYM[scheme]
    b, n, npad = 3, 200, 256
    y = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
         ).astype(np.complex64)
    nv = rng.uniform(0.05, 0.5, size=(b, n)).astype(np.float32)
    sgn = planar_sgn_np(0x1234 * 2 ** 14 + 7, n * m, m, npad)
    got = np.asarray(demap_planar(jnp.asarray(y.real), jnp.asarray(y.imag),
                                  jnp.asarray(1.0 / nv), jnp.asarray(sgn),
                                  scheme))
    assert got.shape == (b, m, npad)
    ref = np.asarray(demodulate_maxlog(jnp.asarray(y), scheme,
                                       jnp.asarray(nv))).reshape(b, n, m)
    ref = ref * sgn[:, :n].T[None]
    np.testing.assert_allclose(got[:, :, :n].transpose(0, 2, 1), ref,
                               rtol=1e-5, atol=1e-4)
    assert np.all(got[:, :, n:] == 0.0)
