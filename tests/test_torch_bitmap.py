"""Bitmap generation in the port is bit-identical to the JAX package.

The port's words are int32 bit patterns; they are compared with the
reference's uint32 words through a ``.view``, never by value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as jbm
from repro_torch.core import bitmap as tbm
from repro_torch.core.constants import PAD_TOKEN


def _collection(n=64, width=40, seed=0, universe=2**31 - 2):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, width + 1, n).astype(np.int32)
    lens[:3] = (0, 1, width)  # an empty set, a singleton and a full row
    toks = np.full((n, width), PAD_TOKEN, np.int32)
    for i, l in enumerate(lens):
        toks[i, :l] = np.sort(rng.choice(universe, size=l, replace=False))
    return toks, lens


@pytest.fixture(scope="module")
def sets():
    return _collection()


@pytest.mark.parametrize("method", ["set", "xor", "next"])
@pytest.mark.parametrize("mix", [False, True])
@pytest.mark.parametrize("b", [64, 128, 256, 4096])
def test_words_bit_identical(sets, method, mix, b):
    toks, lens = sets
    want = np.asarray(jbm.generate_bitmaps(jnp.asarray(toks), jnp.asarray(lens), b,
                                           method=method, mix=mix))
    got = tbm.generate_bitmaps(torch.from_numpy(toks), torch.from_numpy(lens), b,
                               method=method, mix=mix)
    assert got.dtype == torch.int32 and got.shape == (len(lens), b // 32)
    assert want.dtype == np.uint32
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_next_saturates_small_bitmaps():
    """n >= b: Bitmap-Next fills every bit, as Algorithm 5's early exit does."""
    toks, lens = _collection(n=16, width=80, seed=3, universe=1000)
    want = np.asarray(jbm.generate_bitmaps(jnp.asarray(toks), jnp.asarray(lens), 32,
                                           method="next"))
    got = tbm.generate_bitmaps(torch.from_numpy(toks), torch.from_numpy(lens), 32,
                               method="next")
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.all(got.numpy().view(np.uint32)[lens >= 32] == 0xFFFFFFFF)


def test_packing_popcount_and_hamming_match_reference(sets):
    toks, lens = sets
    w = tbm.generate_bitmaps(torch.from_numpy(toks), torch.from_numpy(lens), 256,
                             method="xor")
    wj = jnp.asarray(w.numpy().view(np.uint32))
    assert np.array_equal(tbm.unpack_bits(w).numpy(), np.asarray(jbm.unpack_bits(wj)))
    assert np.array_equal(tbm.unpack_bits(w, 100).numpy(), np.asarray(jbm.unpack_bits(wj, 100)))
    assert torch.equal(tbm.pack_bits(tbm.unpack_bits(w)), w)
    assert np.array_equal(tbm.popcount_rows(w).numpy(), np.asarray(jbm.popcount_rows(wj)))
    assert np.array_equal(tbm.hamming_packed(w, w[:7]).numpy(),
                          np.asarray(jbm.hamming_packed(wj, wj[:7])))
    edge = np.array([[0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]], np.uint32)
    assert np.array_equal(tbm.popcount32(torch.from_numpy(edge.view(np.int32))).numpy(),
                          np.asarray(jbm.popcount32(jnp.asarray(edge))).astype(np.int32))


@pytest.mark.parametrize("mix", [False, True])
def test_hash_positions_match_reference(mix):
    toks = np.array([0, 1, 31, 32, 12345, 2**31 - 2, PAD_TOKEN], np.int32)
    for b in (32, 96, 4096):
        assert np.array_equal(tbm.hash_positions(torch.from_numpy(toks), b, mix).numpy(),
                              np.asarray(jbm.hash_positions(jnp.asarray(toks), b, mix)))


@pytest.mark.parametrize("tau", [0.3, 0.5, 0.6, 0.8, 0.95])
@pytest.mark.parametrize("b", [64, 128, 1024])
def test_choose_method_matches_reference(tau, b):
    assert tbm.choose_method(tau, b) == jbm.choose_method(tau, b)


def test_full_size_path_methods():
    """At b = 128 the smoke's tau = 0.8 picks Xor and tau = 0.5 picks Set."""
    assert tbm.choose_method(0.8, 128) == "xor"
    assert tbm.choose_method(0.5, 128) == "set"


@pytest.mark.parametrize("b", [0, -32, 48, 100])
def test_bad_widths_raise(sets, b):
    toks, lens = sets
    with pytest.raises(ValueError, match="multiple of 32"):
        tbm.generate_bitmaps(torch.from_numpy(toks), torch.from_numpy(lens), b)


def test_bad_methods_raise(sets):
    toks, lens = sets
    with pytest.raises(ValueError, match="unknown bitmap method"):
        tbm.generate_bitmaps(torch.from_numpy(toks), torch.from_numpy(lens), 64,
                             method="bloom")
    with pytest.raises(ValueError, match="tau_jaccard"):
        tbm.generate_bitmaps(torch.from_numpy(toks), torch.from_numpy(lens), 64,
                             method="combined")
