"""The plain versions of the port's postings kernels and of the Hamming
matrix against the JAX package's, and their dispatch, on the CPU.

``entry_filter_ref`` and ``pair_verdict_ref`` (integer prune table) must
equal ``repro.kernels.ref``'s (float32 thresholds) exactly over the sweep of
``tests/test_postings_kernel.py``: G ∈ {5, 100, 1024, 2500, 3000}, W ∈ {1, 4,
128}, self-join on and off, every similarity (cosine keys by product), the
cutoff hit and not, empty rows and invalid slots; ``ops.hamming_matrix``
must equal the reference's on odd shapes.  The CUDA kernels are held
against these plain versions on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SIM_TAUS = [("jaccard", 0.7), ("cosine", 0.6), ("dice", 0.75), ("overlap", 3.0)]


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _entries(g, seed, empty):
    rng = np.random.default_rng(seed)
    arrs = dict(
        len_r=rng.integers(0 if empty else 1, 30, g).astype(np.int32),
        pos_r=rng.integers(0, 10, g).astype(np.int32),
        len_s=rng.integers(0 if empty else 1, 30, g).astype(np.int32),
        pos_s=rng.integers(0, 10, g).astype(np.int32),
        lo=rng.integers(0, 15, g).astype(np.int32),
        hi=rng.integers(8, 40, g).astype(np.int32),
        idx_r=rng.integers(0, 60, g).astype(np.int32),
        idx_s=rng.integers(0, 60, g).astype(np.int32),
    )
    valid = rng.random(g) > 0.2
    return arrs, valid


@pytest.mark.parametrize("g", [5, 100, 1024, 2500, 3000])
@pytest.mark.parametrize("self_join", [False, True])
def test_entry_filter_ref_matches_reference(g, self_join):
    arrs, valid = _entries(g, seed=g + self_join, empty=g % 2 == 0)
    jargs = [jnp.asarray(a) for a in arrs.values()]
    targs = [_t(a) for a in arrs.values()]
    kept = 0
    for sim, tau in SIM_TAUS:
        want = np.asarray(jref.entry_filter_ref(*jargs, jnp.asarray(valid), sim=sim, tau=tau,
                                                self_join=self_join))
        got = tref.entry_filter_ref(*targs, torch.from_numpy(valid), sim=sim, tau=tau,
                                    self_join=self_join)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want), sim
        via_ops = tops.entry_filter(*targs, torch.from_numpy(valid), sim, tau, self_join)
        assert torch.equal(via_ops, got)
        kept += int(want.sum())
    assert 0 < kept < 4 * g


def test_entry_filter_respects_each_filter():
    one = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
    base = dict(len_r=10, pos_r=0, len_s=10, pos_s=0, lo=8, hi=12, idx_r=3, idx_s=7)

    def run(self_join=False, valid=True, **over):
        kw = {k: one(v) for k, v in {**base, **over}.items()}
        return bool(tref.entry_filter_ref(*kw.values(), torch.tensor([valid]), sim="jaccard",
                                          tau=0.8, self_join=self_join)[0])

    assert run()
    assert not run(valid=False)
    assert not run(len_r=0) and not run(len_s=0)
    assert not run(len_r=7) and not run(len_r=13)
    assert not run(pos_r=5, pos_s=5)  # 1 + min(4, 4) = 5 < 8.9 needed
    assert run(self_join=True) and not run(self_join=True, idx_r=7)


def _words(g, w, seed, *, same=False):
    rng = np.random.default_rng(seed)
    wr = rng.integers(0, 2**32, (g, w), dtype=np.uint32)
    ws = wr.copy() if same else rng.integers(0, 2**32, (g, w), dtype=np.uint32)
    ws[::7] = wr[::7]  # some identical rows: ham = 0, the verdict passes
    lr = rng.integers(0, 40, g).astype(np.int32)
    ls = rng.integers(0, 40, g).astype(np.int32)
    lr[::9] = 0
    return wr, ws, lr, ls


@pytest.mark.parametrize("g", [5, 100, 1024, 2500, 3000])
@pytest.mark.parametrize("w", [1, 4, 128])
def test_pair_verdict_ref_matches_reference(g, w):
    wr, ws, lr, ls = _words(g, w, seed=g * w)
    j = [jnp.asarray(a) for a in (wr, ws, lr, ls)]
    t = [_t(a) for a in (wr, ws, lr, ls)]
    for sim, tau in SIM_TAUS:
        for cutoff in (1 << 30, 12):
            want = np.asarray(jref.pair_verdict_ref(*j, sim=sim, tau=tau, cutoff=cutoff))
            got = tref.pair_verdict_ref(*t, sim=sim, tau=tau, cutoff=cutoff)
            assert got.dtype == torch.bool and np.array_equal(got.numpy(), want), (sim, cutoff)
            assert torch.equal(tops.pair_verdict(*t, sim, tau, cutoff), got)
            if cutoff == 12 and sim == "jaccard":
                assert 0 < int(got.sum()) < g or g == 5


def test_pair_verdict_is_the_dense_verdicts_diagonal():
    wr, ws, lr, ls = (_t(a) for a in _words(64, 2, seed=9))
    dense = tref.candidate_matrix_ref(wr, ws, lr, ls, sim="cosine", tau=0.7,
                                      self_join=False, cutoff=10)
    pairwise = tref.pair_verdict_ref(wr, ws, lr, ls, sim="cosine", tau=0.7, cutoff=10)
    assert torch.equal(torch.diagonal(dense), pairwise)


@pytest.mark.parametrize("nr,ns,w", [(33, 70, 1), (64, 64, 4), (31, 17, 128), (1, 1, 4),
                                     (0, 5, 4)])
def test_hamming_matrix_matches_reference(nr, ns, w):
    rng = np.random.default_rng(nr * ns + w)
    wr = rng.integers(0, 2**32, (nr, w), dtype=np.uint32)
    ws = rng.integers(0, 2**32, (ns, w), dtype=np.uint32)
    want = np.asarray(jops.hamming_matrix(jnp.asarray(wr), jnp.asarray(ws), impl="ref"))
    got = tops.hamming_matrix(_t(wr), _t(ws))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(tref.hamming_matrix_ref(_t(wr), _t(ws)), got)


def test_dispatch_on_cpu_tensors():
    wr, ws, lr, ls = (_t(a) for a in _words(50, 4, seed=3))
    arrs, valid = _entries(50, seed=3, empty=True)
    ent = [_t(a) for a in arrs.values()] + [torch.from_numpy(valid)]
    want_v = tref.pair_verdict_ref(wr, ws, lr, ls, sim="dice", tau=0.6)
    want_e = tref.entry_filter_ref(*ent, sim="dice", tau=0.6, self_join=False)
    for impl in ("auto", "ref"):
        assert torch.equal(tops.pair_verdict(wr, ws, lr, ls, "dice", 0.6, impl=impl), want_v)
    for impl in ("auto", "ref", "ref_mxu"):  # ref_mxu has no words here: it is ref
        assert torch.equal(tops.entry_filter(*ent, "dice", 0.6, impl=impl), want_e)
    for impl in ("swar", "swar_tiled"):
        with pytest.raises(ValueError, match="CUDA kernel"):
            tops.pair_verdict(wr, ws, lr, ls, "dice", 0.6, impl=impl)
    for impl in ("swar", "swar_tiled", "mxu"):
        with pytest.raises(ValueError, match="CUDA kernel"):
            tops.entry_filter(*ent, "dice", 0.6, impl=impl)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tops.hamming_matrix(wr, ws, impl="swar")
    # The bit-plane impls: mxu is a CUDA kernel, ref_mxu equals ref.
    with pytest.raises(ValueError, match="CUDA kernel"):
        tops.pair_verdict(wr, ws, lr, ls, "dice", 0.6, impl="mxu")
    with pytest.raises(ValueError, match="CUDA kernel"):
        tops.hamming_matrix(wr, ws, impl="mxu")
    assert torch.equal(tops.pair_verdict(wr, ws, lr, ls, "dice", 0.6, impl="ref_mxu"), want_v)
    assert torch.equal(tops.hamming_matrix(wr, ws, impl="ref_mxu"),
                       tref.hamming_matrix_ref(wr, ws))
    with pytest.raises(ValueError, match="unknown impl"):
        tops.hamming_matrix(wr, ws, impl="swar_tiled")
    with pytest.raises(ValueError, match="interpret"):
        tops.pair_verdict(wr, ws, lr, ls, "dice", 0.6, interpret=True)
