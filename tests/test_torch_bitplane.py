"""The port's bit-plane impls against the JAX package's, on the CPU.

``ops.hamming_matrix``, ``ops.candidate_matrix`` and ``ops.pair_verdict`` at
``impl="ref_mxu"`` (the port's plain bit-plane versions) and the two plain
versions themselves must equal the JAX package's ``ops`` at ``impl="mxu",
interpret=True`` (its Pallas bit-plane kernels, interpreted) and at
``impl="ref_mxu"``, exactly: b ∈ {64, 512, 1024, 4096}, odd sizes (96 × 64;
G ∈ {5, 2500}), every similarity, the cutoff hit and not, all-pass,
all-prune and empty rows; ``ops.count_candidates(impl="ref_mxu")`` (the
tensor-core count's arithmetic) against the JAX package's count.  Then the
dispatch: on CUDA devices ``auto`` is the reference's accelerator rule for
``hamming_matrix`` and ``pair_verdict`` (the bit-plane kernels from
b = 512), the tensor-core verdict kernels at every b for
``candidate_matrix`` and ``count_candidates``, and ``entry_filter(mxu)``
the SWAR entry kernel.  The CUDA kernels themselves are held against these
plain versions on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds as jbounds
from repro.core.bitmap import popcount_rows as jpopcount_rows
from repro.core.bitmap import unpack_bits as junpack_bits
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bitmap as tbm
from repro_torch.core import bounds as tbounds
from repro_torch.kernels import bitmap_filter, bitplane, compaction, postings
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

WIDTHS = [64, 512, 1024, 4096]
SIM_TAUS = [("jaccard", 0.6), ("cosine", 0.75), ("dice", 0.5), ("overlap", 3.0)]


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _operands(n, b, seed, kind="random", hi=40):
    """Uniformly random words and lengths below ``hi``; ``kind`` bends
    them to all-pass, all-prune or empty rows."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (n, b // 32), dtype=np.uint32)
    lens = rng.integers(0, hi, n).astype(np.int32)
    if kind == "all_pass":      # identical zero bitmaps, equal sizes: ub == |r|
        words[:] = 0
        lens[:] = 20
    elif kind == "all_prune":   # random words, tiny sets: ub < 0
        lens[:] = 2
    elif kind == "empty_rows":
        lens[::3] = 0
    return words, lens


@pytest.mark.parametrize("b", WIDTHS)
def test_planes_and_plain_versions_match_reference(b):
    wr, _ = _operands(96, b, b)
    ws, _ = _operands(64, b, b + 1)
    ws[::5] = wr[:64:5]  # some identical rows
    jr, js = jnp.asarray(wr), jnp.asarray(ws)
    pr, ps = tbm.unpack_planes(_t(wr)), tbm.unpack_planes(_t(ws))
    assert pr.dtype == torch.int8 and pr.shape == (96, b)
    assert np.array_equal(pr.numpy(), np.asarray(junpack_bits(jr)).astype(np.int8))
    assert torch.equal(pr, tbm.unpack_bits(_t(wr)).to(torch.int8))
    pc_r, pc_s = tbm.popcount_rows(_t(wr)), tbm.popcount_rows(_t(ws))
    assert np.array_equal(pc_r.numpy(), np.asarray(jpopcount_rows(jr)))
    jpr, jps = junpack_bits(jr).astype(jnp.int8), junpack_bits(js).astype(jnp.int8)
    want = np.asarray(jref.bitplane_hamming_ref(jpr, jps, jpopcount_rows(jr),
                                                jpopcount_rows(js)))
    got = tref.bitplane_hamming_ref(pr, ps, pc_r, pc_s)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    want_p = np.asarray(jref.bitplane_pair_hamming_ref(jpr[:64], jps, jpopcount_rows(jr)[:64],
                                                       jpopcount_rows(js)))
    got_p = tref.bitplane_pair_hamming_ref(pr[:64], ps, pc_r[:64], pc_s)
    assert got_p.dtype == torch.int32 and np.array_equal(got_p.numpy(), want_p)
    assert torch.equal(got_p, torch.diagonal(got[:64]))


@pytest.mark.parametrize("b", WIDTHS)
def test_hamming_matrix_ref_mxu_matches_reference(b):
    wr, _ = _operands(96, b, 2 * b)
    ws, _ = _operands(64, b, 2 * b + 1)
    jr, js = jnp.asarray(wr), jnp.asarray(ws)
    got = tops.hamming_matrix(_t(wr), _t(ws), impl="ref_mxu")
    for kw in (dict(impl="mxu", interpret=True), dict(impl="ref_mxu")):
        assert np.array_equal(got.numpy(), np.asarray(jops.hamming_matrix(jr, js, **kw))), kw
    assert torch.equal(got, tops.hamming_matrix(_t(wr), _t(ws), impl="ref"))


@pytest.mark.parametrize("b", WIDTHS)
@pytest.mark.parametrize("kind", ["random", "all_pass", "all_prune", "empty_rows"])
def test_candidate_matrix_ref_mxu_matches_reference(b, kind):
    (wr, lr), (ws, ls) = _operands(96, b, b, kind), _operands(64, b, b + 1, kind)
    if kind in ("random", "empty_rows"):
        ws[::4] = wr[:64:4]  # identical rows pass
    j = [jnp.asarray(a) for a in (wr, ws, lr, ls)]
    t = [_t(a) for a in (wr, ws, lr, ls)]
    # The interpreted Pallas kernel once per width (each sim in turn); the
    # reference's bit-plane plain version for every sim, cutoff and triangle.
    isim = SIM_TAUS[WIDTHS.index(b)][0]
    passed = 0
    for sim, tau in SIM_TAUS:
        for self_join, cutoff in ((False, 1 << 30), (True, 12)):
            got = tops.candidate_matrix(*t, sim, tau, self_join, cutoff, impl="ref_mxu")
            want = np.asarray(jops.candidate_matrix(*j, sim, tau, self_join, cutoff,
                                                    impl="ref_mxu"))
            assert got.dtype == torch.bool and np.array_equal(got.numpy(), want), sim
            assert torch.equal(got, tops.candidate_matrix(*t, sim, tau, self_join, cutoff,
                                                          impl="ref"))
            if (sim, self_join) == (isim, False):
                interp = jops.candidate_matrix(*j, sim, tau, self_join, cutoff, impl="mxu",
                                               interpret=True)
                assert np.array_equal(got.numpy(), np.asarray(interp)), sim
            passed += int(got.sum())
    triangle = sum(i < j for i in range(96) for j in range(64))
    want_passed = {"all_pass": 4 * (96 * 64 + triangle), "all_prune": 0}
    assert passed == want_passed.get(kind, passed) and (passed > 0 or kind == "all_prune")


@pytest.mark.parametrize("g", [5, 2500])
@pytest.mark.parametrize("b", WIDTHS)
def test_pair_verdict_ref_mxu_matches_reference(g, b):
    (wr, lr), (ws, ls) = _operands(g, b, g + b), _operands(g, b, g + b + 1)
    ws[::3] = wr[::3]  # identical rows: ham = 0, the verdict passes
    lr[::7] = 0
    j = [jnp.asarray(a) for a in (wr, ws, lr, ls)]
    t = [_t(a) for a in (wr, ws, lr, ls)]
    isim = SIM_TAUS[WIDTHS.index(b)][0]
    for sim, tau in SIM_TAUS:
        for cutoff in (1 << 30, 12):
            got = tops.pair_verdict(*t, sim, tau, cutoff, impl="ref_mxu")
            want = np.asarray(jops.pair_verdict(*j, sim, tau, cutoff, impl="ref_mxu"))
            assert got.dtype == torch.bool and np.array_equal(got.numpy(), want), (sim, cutoff)
            assert torch.equal(got, tops.pair_verdict(*t, sim, tau, cutoff, impl="ref"))
            if sim == isim:
                interp = jops.pair_verdict(*j, sim, tau, cutoff, impl="mxu", interpret=True)
                assert np.array_equal(got.numpy(), np.asarray(interp)), (sim, cutoff)
            if cutoff == 12 and g > 5:
                assert 0 < int(got.sum()) < g


def test_verdict_from_hamming_is_the_plain_verdict():
    wr, lr = _operands(50, 128, 1, "empty_rows")
    ws, ls = _operands(50, 128, 2)
    t = [_t(a) for a in (wr, ws, lr, ls)]
    table = tref.prune_table_for("dice", 0.6, t[2], t[3])
    ham = tref.hamming_matrix_ref(t[0], t[1])
    got = tbounds.verdict_from_hamming(ham, t[2][:, None], t[3][None, :], table,
                                       sim="dice", cutoff=30)
    assert torch.equal(got, tref.candidate_matrix_ref(*t, sim="dice", tau=0.6,
                                                      self_join=False, cutoff=30))


def test_auto_resolves_as_the_reference_does_on_its_accelerator(monkeypatch):
    """On CUDA devices ``auto`` is the reference's accelerator rule; on the
    CPU it is the plain version.  The mxu impls are gated by device like
    the others."""
    monkeypatch.setattr(jops, "_on_tpu", lambda: True)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for b in (32, 128, 256, 480, 512, 1024, 4096):
        assert tops.resolve_impl("auto", cuda, b) == jops.resolve_impl("auto", b)
        assert (tops._resolve_pairwise_impl("auto", cuda, b)
                == jops._resolve_pairwise_impl("auto", b))
        assert tops.resolve_impl("auto", cuda, b) == ("mxu" if b >= 512 else "swar")
        assert tops.resolve_impl("auto", cpu, b) == "ref"
    for impl in ("auto", "mxu", "swar", "swar_tiled"):
        assert tops._resolve_entry_impl(impl, cuda) == "swar" == jops._resolve_entry_impl(impl)
    assert tops._resolve_entry_impl("ref_mxu", cpu) == "ref"
    with pytest.raises(ValueError, match="CUDA kernel"):
        tops.resolve_impl("mxu", cpu, 1024)
    with pytest.raises(ValueError, match="CPU path"):
        tops.resolve_impl("ref_mxu", cuda, 1024)
    with pytest.raises(ValueError, match="unknown impl"):
        tops.resolve_impl("swar_tiled", cuda, 1024)


def test_mxu_dispatch_of_count_candidates_and_entry_filter(monkeypatch):
    """``count_candidates`` launches the tensor-core count kernel under
    ``mxu`` and ``auto`` (at b = 1024 and below 512 alike) and the SWAR one
    under ``swar``; ``entry_filter(mxu)`` the SWAR entry kernel.  The
    resolution is forced to the card's here, and the kernels' wrappers are
    replaced by recorders."""
    calls = []
    orig = tops.resolve_impl
    monkeypatch.setattr(tops, "resolve_impl",
                        lambda impl, device, b, **kw: orig(impl, torch.device("cuda"), b, **kw))
    monkeypatch.setattr(compaction, "count_candidates_cuda",
                        lambda *a, **k: calls.append("count_candidates"))
    monkeypatch.setattr(compaction, "count_candidates_mxu_cuda",
                        lambda *a, **k: calls.append("count_candidates_mxu"))
    monkeypatch.setattr(postings, "entry_filter_cuda",
                        lambda *a, **k: calls.append("entry_filter"))
    wr, lr = (_t(a) for a in _operands(8, 1024, 3))
    tops.count_candidates(wr, wr, lr, lr, lr, lr, "jaccard", 0.8)
    tops.count_candidates(wr, wr, lr, lr, lr, lr, "jaccard", 0.8, impl="mxu")
    tops.count_candidates(wr, wr, lr, lr, lr, lr, "jaccard", 0.8, impl="swar")
    tops.count_candidates(wr[:, :4], wr[:, :4], lr, lr, lr, lr, "jaccard", 0.8)   # b = 128
    tops.entry_filter(*[lr] * 8, lr > 0, "jaccard", 0.8, impl="mxu")
    assert calls == ["count_candidates_mxu", "count_candidates_mxu", "count_candidates",
                     "count_candidates_mxu", "entry_filter"]


# The wrapper ``auto`` launches on CUDA tensors, by entry point: the
# reference's accelerator rule (bit planes from b = 512) for hamming_matrix
# and pair_verdict, the tensor-core verdict kernels at every b for the two
# dense verdicts (the form the card measured faster), the SWAR entry filter.
AUTO_KERNELS = {
    "hamming_matrix": lambda b: "bitplane_hamming" if b >= 512 else "hamming_matrix",
    "candidate_matrix": lambda b: "candidate_matrix_mxu",
    "count_candidates": lambda b: "count_candidates_mxu",
    "pair_verdict": lambda b: "pair_verdict_bitplane" if b >= 512 else "pair_verdict_tiled",
    "entry_filter": lambda b: "entry_filter",
}


@pytest.mark.parametrize("entry", sorted(AUTO_KERNELS))
@pytest.mark.parametrize("b", [64, 256, 512, 1024])
def test_auto_dispatch_rule_per_entry_point(monkeypatch, entry, b):
    """Under ``auto`` each entry point launches exactly the kernel the rule
    names, with the resolution forced to the card's and every CUDA wrapper
    replaced by a recorder."""
    calls = []
    orig = tops.resolve_impl
    monkeypatch.setattr(tops, "resolve_impl",
                        lambda impl, device, b, **kw: orig(impl, torch.device("cuda"), b, **kw))
    wrappers = {"hamming_matrix": bitmap_filter, "candidate_matrix": bitmap_filter,
                "candidate_matrix_mxu": bitmap_filter, "bitplane_hamming": bitplane,
                "count_candidates": compaction, "count_candidates_mxu": compaction,
                "pair_verdict": postings, "pair_verdict_tiled": postings,
                "pair_verdict_bitplane": postings, "entry_filter": postings}
    for name, module in wrappers.items():
        monkeypatch.setattr(module, f"{name}_cuda",
                            lambda *a, name=name, **k: calls.append(name) or
                            torch.zeros(a[0].shape[0], dtype=torch.bool))
    (wr, lr), (ws, ls) = (tuple(_t(a) for a in _operands(16, b, b + k)) for k in (0, 1))
    args = {"hamming_matrix": (wr, ws),
            "candidate_matrix": (wr, ws, lr, ls, "jaccard", 0.8, False),
            "count_candidates": (wr, ws, lr, ls, lr, lr, "jaccard", 0.8),
            "pair_verdict": (wr, ws, lr, ls, "jaccard", 0.8),
            "entry_filter": (*[lr] * 8, lr > 0, "jaccard", 0.8)}[entry]
    getattr(tops, entry)(*args)
    assert calls == [AUTO_KERNELS[entry](b)]


@pytest.mark.parametrize("sim,tau", SIM_TAUS)
@pytest.mark.parametrize("self_join", [False, True])
@pytest.mark.parametrize("tile", [32, 64, 256])
def test_count_candidates_ref_mxu_matches_reference(sim, tau, self_join, tile):
    """The bit-plane plain count (Hamming distances from the planes and row
    popcounts, as the tensor-core count takes them) equals the JAX
    package's count, window and triangle included."""
    (wr, lr), (ws, ls) = _operands(96, 64, tile, "empty_rows"), _operands(80, 64, tile + 1)
    ws[::4] = wr[:80:4]  # identical rows pass,
    wr[48:], lr[48:] = wr[:48], lr[:48]  # and in a self-join, rows i and i + 48
    if self_join:
        ws, ls = wr, lr
    lo, hi = jbounds.length_window_int(sim, tau, lr)
    kw = dict(self_join=self_join, cutoff=25 if sim in ("dice", "overlap") else 1 << 30,
              tile=tile)
    want = jops.count_candidates(*(jnp.asarray(a) for a in (wr, ws, lr, ls, lo, hi)), sim,
                                 tau, impl="ref", **kw)
    got = tops.count_candidates(*(_t(a) for a in (wr, ws, lr, ls, lo, hi)), sim, tau,
                                impl="ref_mxu", **kw)
    for g, r in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(r))
    assert int(got[1].sum()) > 0
