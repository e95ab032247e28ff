"""The bitmap build's entry point and plain version against the JAX package.

``ops.bitmap_build`` (on the card the kernel ``csrc/bitmap_build.cu``, on
the CPU its plain version ``ref.bitmap_build_ref``) and ``generate_bitmaps``
on CPU tensors must give the reference's ``generate_bitmaps`` words bit for
bit (int32 patterns viewed as uint32), for Set, Xor and Next, with and
without the mixer, at widths that are and are not powers of two.  The rows
hold the kernel's edge cases: many tokens hashing to bit b - 1 (Next's
probes wrap past it), ``PAD_TOKEN`` inside a row's length, rows of exactly
b tokens and of more than b (Next saturates), empty rows and a length past
the row.  A tau = 0.35 Jaccard self-join, which Algorithm 6 sends through
Bitmap-Next, must give the reference's pairs and ``JoinStats``.  Every
comparison is exact.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as jbm
from repro.core import join as jjoin
from repro.data.collections import uniform_collection as juniform
from repro_torch.core import bitmap as tbm
from repro_torch.core import join as tjoin
from repro_torch.core.constants import PAD_TOKEN
from repro_torch.data.collections import uniform_collection as tuniform
from repro_torch.kernels import bitmap_build, ops, ref

WIDTHS = (32, 96, 160, 1024)


def _edge_rows(b: int, seed: int = 0):
    """int32 tokens [16, b + 8] and lengths with the kernel's edge cases."""
    rng = np.random.default_rng(seed + b)
    n, l = 16, b + 8
    toks = np.full((n, l), PAD_TOKEN, np.int32)
    lens = np.zeros(n, np.int32)

    def put(i, row, length=None):
        toks[i, :len(row)] = row
        lens[i] = len(row) if length is None else length

    wrap = (b - 1) + b * np.arange(12)           # all hash to b - 1 without the mixer
    put(0, wrap)
    put(1, np.concatenate([wrap[:5], rng.integers(0, 10 * b, 7)]))
    put(2, rng.choice(100 * b, b, replace=False))          # exactly b tokens
    put(3, rng.choice(100 * b, b + 8, replace=False))      # more than b: saturates
    put(4, rng.integers(0, 3 * b, b + 8))                  # repeats, more than b
    row = rng.integers(0, 10**6, 20)
    row[[3, 11]] = PAD_TOKEN                               # PAD inside the length
    put(5, row)
    put(6, [])                                             # empty
    put(7, rng.integers(0, 2**31 - 1, 30), length=l + 5)   # length past the row
    put(8, rng.integers(0, 2**31 - 1, 25), length=10)      # tokens past the length
    for i in range(9, n):
        put(i, rng.integers(0, 2**31 - 1, int(rng.integers(1, 40))))
    return toks, lens


@pytest.fixture(scope="module")
def rows():
    return {b: _edge_rows(b) for b in WIDTHS}


@pytest.mark.parametrize("method", ["set", "xor", "next"])
@pytest.mark.parametrize("mix", [False, True])
@pytest.mark.parametrize("b", WIDTHS)
def test_build_matches_reference(rows, method, mix, b):
    toks, lens = rows[b]
    want = np.asarray(jbm.generate_bitmaps(jnp.asarray(toks), jnp.asarray(lens), b,
                                           method=method, mix=mix))
    t, l = torch.from_numpy(toks), torch.from_numpy(lens)
    got = ops.bitmap_build(t, l, b, method, mix)
    assert got.dtype == torch.int32 and got.shape == (len(lens), b // 32)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(tbm.generate_bitmaps(t, l, b, method=method, mix=mix), got)
    assert torch.equal(tbm.generate_bitmaps(t, l, b, method=method, mix=mix, packed=False),
                       tbm.unpack_bits(got))
    if method == "next":   # min(n, b) ones a row
        valid = (toks != PAD_TOKEN) & (np.arange(toks.shape[1]) < lens[:, None])
        ones = tbm.popcount_rows(got).numpy()
        assert np.array_equal(ones, np.minimum(valid.sum(1), b))


def test_wrap_and_saturation_are_exercised(rows):
    """The edge rows do what they are for: Next wraps row 0's probes past
    bit b - 1 to bit 0, and fills rows 2-4 to all ones."""
    b = 96
    toks, lens = rows[b]
    bits = tbm.unpack_bits(ops.bitmap_build(torch.from_numpy(toks), torch.from_numpy(lens),
                                            b, "next")).numpy()
    assert bits[0, b - 1] and bits[0, :11].all() and not bits[0, 11:b - 1].any()
    assert bits[2:5].all()


def test_empty_collection():
    toks = torch.empty((0, 7), dtype=torch.int32)
    lens = torch.empty((0,), dtype=torch.int32)
    for method in ("set", "xor", "next"):
        got = ops.bitmap_build(toks, lens, 160, method)
        assert got.shape == (0, 5) and got.dtype == torch.int32
        assert torch.equal(tbm.generate_bitmaps(toks, lens, 160, method=method), got)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing(rows):
    toks, lens = (torch.from_numpy(a) for a in rows[32])
    before = {m: f.launches for m, f in bitmap_build.WRAPPERS.items()}
    for method in ("set", "xor", "next"):
        assert torch.equal(ops.bitmap_build(toks, lens, 32, method),
                           ref.bitmap_build_ref(toks, lens, 32, method))
        with pytest.raises(ValueError, match="CUDA tensors"):
            bitmap_build.bitmap_build_cuda(toks, lens, 32, method)
    assert {m: f.launches for m, f in bitmap_build.WRAPPERS.items()} == before
    with pytest.raises(ValueError, match="unknown bitmap method"):
        ops.bitmap_build(toks, lens, 32, "combined")
    with pytest.raises(ValueError, match="unknown bitmap method"):
        bitmap_build.bitmap_build_cuda(toks, lens, 32, "combined")


def test_form_rule_takes_each_side_of_its_switches():
    """The rule that picks the kernel's form (no kernel runs): the lane
    form up to its widest b, which the CUDA source states too; Set and Xor
    in the warp form below ``SET_XOR_LANE_MIN_ROWS`` rows, Next in the lane
    form at any N; an explicit form where it has a kernel."""
    lim, rows = 32 * bitmap_build.LANE_MAX_WORDS, bitmap_build.SET_XOR_LANE_MIN_ROWS
    source = (Path(bitmap_build.__file__).with_name("csrc") / "bitmap_build.cu").read_text()
    assert f"constexpr int kLaneMaxWords = {bitmap_build.LANE_MAX_WORDS};" in source
    for method in ("set", "xor", "next"):
        assert bitmap_build.form(method, lim, 10**6) == "lane"
        assert bitmap_build.form(method, lim + 32, 10**6) == "warp"
        assert bitmap_build.form(method, 32, 10**6) == "lane"
        assert bitmap_build.form(method, lim + 32, 1, "warp") == "warp"
        assert bitmap_build.form(method, 128, 10**6, "warp") == "warp"
        assert bitmap_build.form(method, lim, 1, "lane") == "lane"
        with pytest.raises(ValueError, match="lane form"):
            bitmap_build.form(method, lim + 32, 10**6, "lane")
        with pytest.raises(ValueError, match="unknown form"):
            bitmap_build.form(method, 128, 10**6, "block")
    for b in (128, 1024):
        for method in ("set", "xor"):
            assert bitmap_build.form(method, b, rows - 1) == "warp"
            assert bitmap_build.form(method, b, rows) == "lane"
        assert bitmap_build.form("next", b, 1) == "lane"
        assert bitmap_build.form("next", b, rows - 1) == "lane"


def test_next_join_matches_reference():
    """tau = 0.35 sends the combined method to Bitmap-Next (b = 128)."""
    cj, ct = juniform(n_sets=240, seed=5), tuniform(n_sets=240, seed=5)
    assert np.array_equal(cj.tokens, ct.tokens)
    assert tbm.choose_method(0.35, 128) == "next"
    kw = dict(b=128, block=256, method="combined", compaction="device", return_stats=True)
    rp, rs = jjoin.blocked_bitmap_join(cj, "jaccard", 0.35, **kw)
    gp, gs = tjoin.blocked_bitmap_join(ct, "jaccard", 0.35, device="cpu", **kw)
    assert len(rp) > 0 and np.array_equal(rp, gp)
    assert rs.to_dict() == gs.to_dict()
    assert 0 < gs.candidates < gs.total_pairs   # the filter pruned something
