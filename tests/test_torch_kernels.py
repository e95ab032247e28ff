"""The port's plain kernel versions against the JAX package's, and dispatch.

Mirrors ``tests/test_kernels.py`` and ``tests/test_compaction_kernel.py``:
odd sizes, W in {1, 4, 128}, self-join on and off, the cutoff hit and not,
all-pass, all-prune and empty rows.  The reference runs ``impl="ref"``, plus
one Pallas interpret-mode case per kernel at a single 256 x 256 tile.  The
CUDA kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``).  Every output is integer or bool: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds as jbounds
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _words(n, w, seed):
    return np.random.default_rng(seed).integers(0, 2**32, (n, w), dtype=np.uint32)


def _lens(n, seed, lo=0, hi=40):
    return np.random.default_rng(seed).integers(lo, hi, n).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                            if a.dtype == np.uint32 else np.ascontiguousarray(a))


def _operands(case, seed):
    nr, ns, w, kind = case
    wr, ws = _words(nr, w, seed), _words(ns, w, seed + 1)
    lr, ls = _lens(nr, seed + 2), _lens(ns, seed + 3)
    if kind == "all_pass":      # identical zero bitmaps, equal sizes: ub == |r|
        wr, ws = np.zeros_like(wr), np.zeros_like(ws)
        lr, ls = np.full(nr, 20, np.int32), np.full(ns, 20, np.int32)
    elif kind == "all_prune":   # random words, tiny sets: ub < 0
        lr, ls = np.full(nr, 2, np.int32), np.full(ns, 2, np.int32)
    elif kind == "empty_rows":
        lr[::3] = 0
        ls[1::4] = 0
    return wr, ws, lr, ls


SHAPES = [  # nr, ns, W, lengths
    (33, 70, 1, "random"),
    (64, 64, 4, "random"),
    (31, 17, 128, "random"),
    (40, 56, 4, "all_pass"),
    (40, 56, 4, "all_prune"),
    (57, 45, 4, "empty_rows"),
]
VERDICTS = [  # sim, tau, self_join, cutoff
    ("jaccard", 0.6, False, 1 << 30),
    ("cosine", 0.75, True, 1 << 30),
    ("dice", 0.5, False, 12),
    ("overlap", 3.0, True, 25),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("verdict", VERDICTS, ids=lambda v: f"{v[0]}-{v[2]}-{v[3]}")
def test_candidate_matrix_ref_matches_reference(shape, verdict):
    sim, tau, self_join, cutoff = verdict
    wr, ws, lr, ls = _operands(shape, seed=sum(shape[:3]))
    if self_join:
        ws, ls = wr, lr
    kw = dict(sim=sim, tau=tau, self_join=self_join, cutoff=cutoff)
    want = np.asarray(jops.candidate_matrix(jnp.asarray(wr), jnp.asarray(ws), jnp.asarray(lr),
                                            jnp.asarray(ls), impl="ref", **kw))
    got = tops.candidate_matrix(_t(wr), _t(ws), _t(lr), _t(ls), **kw)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    if shape[3] == "all_pass" and not self_join and cutoff > 20:
        assert want.all()
    if shape[3] == "all_prune" and cutoff > 2:
        assert not want.any()


COUNT_CASES = [  # nr, ns, W, tile, sim, tau, self_join, window, cutoff
    (64, 64, 1, 32, "jaccard", 0.6, False, True, 1 << 30),
    (64, 64, 4, 32, "jaccard", 0.6, True, True, 1 << 30),
    (64, 64, 128, 32, "dice", 0.6, False, False, 1 << 30),
    (33, 70, 4, 32, "cosine", 0.5, False, True, 1 << 30),
    (40, 56, 4, 8, "jaccard", 0.8, True, False, 15),
    (300, 290, 4, 256, "overlap", 2.0, False, True, 1 << 30),
]


@pytest.mark.parametrize("case", COUNT_CASES, ids=lambda c: "-".join(map(str, c[:8])))
def test_count_candidates_ref_matches_reference(case):
    nr, ns, w, tile, sim, tau, self_join, window, cutoff = case
    wr, ws, lr, ls = _operands((nr, ns, w, "empty_rows"), seed=nr + w)
    if self_join:
        ws, ls = wr, lr
        ns = nr
    lo, hi = jbounds.length_window_int(sim, tau, lr)
    kw = dict(sim=sim, tau=tau, self_join=self_join, cutoff=cutoff, window=window,
              tile=tile)
    want = jops.count_candidates(jnp.asarray(wr), jnp.asarray(ws), jnp.asarray(lr),
                                 jnp.asarray(ls), jnp.asarray(lo), jnp.asarray(hi),
                                 impl="ref", **kw)
    got = tops.count_candidates(_t(wr), _t(ws), _t(lr), _t(ls), _t(lo), _t(hi), **kw)
    for g, r in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (-(-nr // tile), -(-ns // tile))
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_count_grid_is_the_reference_256_tiling():
    """The default tile keeps the reference's 256 x 256 count grid."""
    wr, ws, lr, ls = _operands((300, 513, 4, "random"), seed=9)
    lo, hi = jbounds.length_window_int("jaccard", 0.6, lr)
    win, cand = tops.count_candidates(_t(wr), _t(ws), _t(lr), _t(ls), _t(lo), _t(hi),
                                      "jaccard", 0.6)
    assert win.shape == cand.shape == (2, 3)


def test_pallas_kernels_in_interpret_mode_match_plain_versions():
    """One 256 x 256 tile through the reference's Pallas kernels (interpret
    mode) against the port's plain versions."""
    wr, ws, lr, ls = _operands((256, 256, 4, "empty_rows"), seed=11)
    lo, hi = jbounds.length_window_int("jaccard", 0.7, lr)
    kw = dict(sim="jaccard", tau=0.7, self_join=True, cutoff=30)
    want = jops.candidate_matrix(jnp.asarray(wr), jnp.asarray(ws), jnp.asarray(lr),
                                 jnp.asarray(ls), impl="swar", interpret=True, tile=256, **kw)
    got = tref.candidate_matrix_ref(_t(wr), _t(ws), _t(lr), _t(ls), **kw)
    assert np.array_equal(got.numpy(), np.asarray(want))
    want_n = jops.count_candidates(jnp.asarray(wr), jnp.asarray(ws), jnp.asarray(lr),
                                   jnp.asarray(ls), jnp.asarray(lo), jnp.asarray(hi),
                                   impl="swar", interpret=True, tile=256, **kw)
    got_n = tref.count_candidates_ref(_t(wr), _t(ws), _t(lr), _t(ls), _t(lo), _t(hi), **kw)
    for g, r in zip(got_n, want_n):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_cpu_tensors_never_launch_the_kernel():
    wr, ws, lr, ls = (_t(a) for a in _operands((8, 8, 4, "random"), seed=1))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, False, impl="swar")
    with pytest.raises(ValueError, match="CUDA kernel"):
        tops.count_candidates(wr, ws, lr, ls, lr, lr, "jaccard", 0.8, impl="swar")


@pytest.mark.parametrize("wrapper", ["candidate_matrix_mxu", "count_candidates_mxu"])
@pytest.mark.parametrize("bad", ["cpu_tensors", "int64_words", "int64_lengths", "uint8_words"])
def test_mxu_verdict_wrappers_raise_before_building(monkeypatch, wrapper, bad):
    """The tensor-core verdict kernels' wrappers refuse CPU tensors and
    wrong dtypes before anything is built (no nvcc here)."""
    from repro_torch.kernels import _build, bitmap_filter, compaction

    monkeypatch.setattr(_build, "library", lambda name: pytest.fail(f"built {name}"))
    wr, ws, lr, ls = (_t(a) for a in _operands((8, 8, 4, "random"), seed=3))
    if bad == "int64_words":
        wr = wr.long()
    elif bad == "int64_lengths":
        lr = lr.long()
    elif bad == "uint8_words":
        wr = wr.view(torch.uint8)
    table = tref.prune_table_for("jaccard", 0.8, ls, ls)
    kw = dict(key_prod=False, self_join=False, cutoff=1 << 30)
    with pytest.raises(ValueError):
        if wrapper == "candidate_matrix_mxu":
            bitmap_filter.candidate_matrix_mxu_cuda(wr, ws, lr, ls, table, **kw)
        else:
            compaction.count_candidates_mxu_cuda(wr, ws, lr, ls, None, None, table,
                                                 tile_r=256, tile_s=256, **kw)


@pytest.mark.parametrize("impl", ["mxu", "ref_mxu"])
def test_bitplane_impls_are_not_ported_yet(impl):
    """The bit-plane impls are ported: on CPU tensors ``mxu`` (a CUDA
    kernel) raises and ``ref_mxu`` (its plain version) equals ``ref``."""
    wr, ws, lr, ls = (_t(a) for a in _operands((8, 8, 4, "random"), seed=2))
    if impl == "mxu":
        with pytest.raises(ValueError, match="CUDA kernel"):
            tops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, False, impl=impl)
        return
    for sj in (False, True):
        assert torch.equal(
            tops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, sj, impl=impl),
            tops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, sj, impl="ref"))


def test_unknown_impl_and_interpret_raise():
    wr, ws, lr, ls = (_t(a) for a in _operands((8, 8, 4, "random"), seed=3))
    with pytest.raises(ValueError, match="unknown impl"):
        tops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, False, impl="swar_tiled")
    with pytest.raises(ValueError, match="interpret"):
        tops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, False, interpret=True)
