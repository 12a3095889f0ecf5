"""make_flat_extractor: slice/strided-pick RE extraction == flat gather.

The PDSCH front-end selects data REs out of the flat subframe grid; that
selection is rewritten from a gather into static slices + periodic
column picks (lteax/phy/grid.py::make_flat_extractor).  These tests pin the
rewrite to the gather semantics exactly, for real PDSCH patterns and for
unstructured patterns that must fall back to per-row gathers.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from lteax.phy.config import PhyConfig
from lteax.phy.grid import pdsch_flat_idx, make_flat_extractor


@pytest.mark.parametrize("n_rb,cfi", [(100, 1), (50, 2), (6, 3)])
def test_extractor_matches_gather_pdsch(n_rb, cfi):
    cfg = PhyConfig(n_rb_dl=n_rb)
    idx = pdsch_flat_idx(cfg, 214, cfi, tuple(range(n_rb)), 1)
    extract, n_struct, n_gather = make_flat_extractor(
        idx, cfg.n_sym_subframe, cfg.n_sc)
    assert n_gather == 0, "full-band PDSCH rows are all structured"
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, cfg.n_sym_subframe * cfg.n_sc)) \
        .astype(np.float32)
    np.testing.assert_array_equal(np.asarray(extract(jnp.asarray(x))),
                                  x[:, idx])


def test_extractor_partial_prbs():
    # non-contiguous PRB allocation -> rows split into several runs
    cfg = PhyConfig(n_rb_dl=25)
    prbs = (0, 1, 2, 7, 8, 11, 20, 24)
    idx = pdsch_flat_idx(cfg, 17, 2, prbs, 4)
    extract, _, _ = make_flat_extractor(idx, cfg.n_sym_subframe, cfg.n_sc)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(cfg.n_sym_subframe * cfg.n_sc).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(extract(jnp.asarray(x))), x[idx])


def test_extractor_unstructured_fallback():
    # a keep-set with no period-p structure must fall back to a row gather
    # and still match
    n_rows, row_len = 4, 64
    rng = np.random.default_rng(2)
    k = np.sort(rng.choice(row_len, size=13, replace=False))
    idx = (2 * row_len + k).astype(np.int32)
    extract, n_struct, n_gather = make_flat_extractor(idx, n_rows, row_len)
    assert n_gather >= 1
    x = rng.standard_normal((2, n_rows * row_len)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(extract(jnp.asarray(x))),
                                  x[:, idx])


def test_extractor_rejects_unsorted():
    with pytest.raises(AssertionError):
        make_flat_extractor(np.array([5, 3, 9]), 1, 16)
