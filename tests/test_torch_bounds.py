"""Parity of the port's numeric base (bounds, expected) with the JAX package.

Every output is an integer or an exactly comparable float, so every
comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds as jb
from repro.core import expected as je
from repro_torch.core import bounds as tb
from repro_torch.core import expected as te

SIMS = ("jaccard", "cosine", "dice", "overlap")
TAUS = (0.5, 0.6, 0.75, 0.8, 0.9, 0.95)
OVERLAP_TAUS = (1.0, 2.0, 3.0, 5.0, 8.0, 12.0)  # overlap thresholds are counts


def _taus(sim):
    return OVERLAP_TAUS if sim == "overlap" else TAUS


def _lmax(sim):
    return 90 if sim == "cosine" else 400


@pytest.mark.parametrize("sim", SIMS)
def test_prune_table_is_the_reference_f32_prune(sim):
    """entry = the smallest integer u with float32(u) >= the reference's
    required_overlap_safe, over the whole key range."""
    lmax = _lmax(sim)
    lr = np.repeat(np.arange(lmax + 1), lmax + 1)
    ls = np.tile(np.arange(lmax + 1), lmax + 1)
    key = lr * ls if sim == "cosine" else lr + ls
    for tau in _taus(sim):
        tab = tb.prune_table(sim, tau, lmax, lmax)
        assert tab.dtype == np.int32 and tab.shape == (key.max() + 1,)
        need = np.asarray(jb.required_overlap_safe(sim, tau, jnp.asarray(lr), jnp.asarray(ls)))
        entry = tab[key]
        assert np.all(entry.astype(np.float32) >= need), (sim, tau)
        assert not np.any((entry - 1).astype(np.float32) >= need), (sim, tau)


@pytest.mark.parametrize("sim", SIMS)
def test_tables_and_windows_match_reference(sim):
    n = np.arange(0, 300)
    for tau in _taus(sim):
        assert np.array_equal(tb.min_overlap_table(sim, tau, 60, 75),
                              jb.min_overlap_table(sim, tau, 60, 75))
        for got, want in zip(tb.length_window_int(sim, tau, n),
                             jb.length_window_int(sim, tau, n)):
            assert got.dtype == want.dtype and np.array_equal(got, want), (sim, tau)
        assert np.array_equal(tb.prefix_length(sim, tau, n), jb.prefix_length(sim, tau, n))
        assert np.array_equal(tb.min_overlap_int(sim, tau, n[:, None], n[None, :40]),
                              jb.min_overlap_int(sim, tau, n[:, None], n[None, :40]))


@pytest.mark.parametrize("sim", SIMS)
def test_torch_twins_match_reference(sim):
    rng = np.random.default_rng(5)
    lr = rng.integers(0, 200, 500).astype(np.int32)
    ls = rng.integers(0, 200, 500).astype(np.int32)
    for tau in _taus(sim)[:3]:
        got = tb.required_overlap_safe(sim, tau, torch.from_numpy(lr), torch.from_numpy(ls))
        want = jb.required_overlap_safe(sim, tau, jnp.asarray(lr), jnp.asarray(ls))
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(want))
        tab = tb.min_overlap_table(sim, tau, 200, 200)
        got = tb.min_overlap_gather(sim, torch.from_numpy(tab), torch.from_numpy(lr),
                                    torch.from_numpy(ls))
        want = jb.min_overlap_gather(sim, jnp.asarray(tab), jnp.asarray(lr), jnp.asarray(ls))
        assert np.array_equal(got.numpy(), np.asarray(want))
    pr = rng.integers(0, 5, 500)
    ps = rng.integers(0, 5, 500)
    assert np.array_equal(
        tb.positional_upper_bound_int(torch.from_numpy(lr), torch.from_numpy(ls),
                                      torch.from_numpy(pr), torch.from_numpy(ps)).numpy(),
        np.asarray(jb.positional_upper_bound_int(lr, ls, pr, ps)))


def test_integer_window_drift_cases():
    """The float-drift boundaries fixed in the reference: 5 * 0.8 is
    4.000...02, floor((1 - 0.8) * 5) is 0."""
    lo, hi = tb.length_window_int("jaccard", 0.8, np.array([4, 5]))
    assert (int(lo[1]), int(hi[0])) == (4, 5)
    assert int(tb.prefix_length("jaccard", 0.8, 5)) == 2
    assert int(tb.prefix_length("jaccard", 0.8, 5)) == int(jb.prefix_length("jaccard", 0.8, 5))


def test_large_key_prune_entries_step_below_the_ceiling():
    """Past 2^24 float32 rounds integers: entries stay minimal there too."""
    tab = tb.prune_table("overlap", float(1 << 25) + 3.0, 1, 1)
    need = np.float32(float(1 << 25) + 3.0) * np.float32(1 - 1e-6) - np.float32(1e-6)
    assert np.float32(tab[0]) >= need
    assert not np.float32(int(tab[0]) - 1) >= need


@pytest.mark.parametrize("b", [32, 64, 128, 4096])
def test_expected_cutoffs_and_crossovers_match_reference(b):
    assert te.combined_crossovers(b) == je.combined_crossovers(b)
    for method in ("set", "xor", "next"):
        for tau in TAUS:
            assert te.cutoff_point(method, b, tau) == je.cutoff_point(method, b, tau)
    n = np.arange(1, 400)
    for method in ("set", "xor", "next"):
        assert np.array_equal(te.expected_bound(method, b, n), je.expected_bound(method, b, n))
