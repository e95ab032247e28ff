"""The port's postings index and indexed driver against the JAX package's,
on the CPU.

* ``bounds.prefix_length_ell`` equals the reference's over a length grid,
  4 similarities, a range of τ and ℓ in {1, 2, 3}.
* ``build_postings`` is equal to ``repro.index.postings.build_postings``
  field for field, for every similarity, two thresholds each and ℓ in
  {1, 3}, and on empty and degenerate collections.
* ``indexed_bitmap_join`` gives the pairs and every ``JoinStats`` counter
  of ``repro.index.indexed_bitmap_join`` (b = 32, ``probe_block=8``, so
  every join walks several chunks) for the 4 similarities × {uniform,
  skewed, dup-heavy} self-joins (R×S and forced capacities:
  ``tests/test_torch_index_rs.py``).
* The port's driver runs on an index the JAX package built.
* The reified first chunk (``chunk_step_spec``) and the three stages
  composed by hand, masks included, equal the reference's.

The reference runs ``impl="auto"`` (its plain path on the CPU) and
compiles one chunk step per (similarity, shape, capacity); the grid is cut
to one threshold per similarity to fit the time budget.
"""

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core import join as jjoin
from repro.core.collection import from_lists as jfrom_lists
from repro.index import indexed_bitmap_join as jindexed
from repro.index import postings as jpostings
from repro_torch.core import engine as tengine
from repro_torch.core.collection import from_lists as tfrom_lists
from repro_torch.index import candidates as tcand
from repro_torch.index import indexed_bitmap_join as tindexed
from repro_torch.index import postings as tpostings
from test_torch_join import _assert_same, _both, _sets

SIM_TAUS = [("jaccard", 0.6), ("cosine", 0.7), ("dice", 0.85), ("overlap", 2.0)]
KINDS = ("uniform", "skewed", "dup_heavy")
_PAD = 16  # the padded width of test_torch_join's collections
_KW = dict(b=32, probe_block=8, return_stats=True)
_FIELDS = ("sim", "tau", "ell", "max_len", "vocab", "vocab_tid", "starts",
           "post_set", "post_pos", "post_len", "post_key", "prefix_len")


def _assert_same_index(ref, got):
    for f in _FIELDS:
        a, b = getattr(ref, f), getattr(got, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


@pytest.mark.parametrize("sim", ["jaccard", "cosine", "dice", "overlap"])
def test_prefix_length_ell_matches_reference(sim):
    from repro.core import bounds as jbounds
    from repro_torch.core import bounds as tbounds

    n = np.arange(0, 400)
    taus = (1.0, 2.0, 3.0, 7.0) if sim == "overlap" else (0.5, 0.6, 0.75, 0.8, 0.9, 0.95)
    for tau in taus:
        for ell in (1, 2, 3):
            want = jbounds.prefix_length_ell(sim, tau, n, ell)
            got = tbounds.prefix_length_ell(sim, tau, n, ell)
            assert got.dtype == want.dtype and np.array_equal(got, want), (tau, ell)


@pytest.mark.parametrize("ell", [1, 3])
@pytest.mark.parametrize("sim,taus", [("jaccard", (0.6, 0.9)), ("cosine", (0.5, 0.8)),
                                      ("dice", (0.7, 0.95)), ("overlap", (2.0, 5.0))])
def test_build_postings_matches_reference(sim, taus, ell):
    cj, ct = _both(_sets("skewed", seed=ell + len(sim)))
    jprep, tprep = jengine.prepare(cj), tengine.prepare(ct, device="cpu")
    for tau in taus:
        _assert_same_index(jpostings.build_postings(jprep, sim, tau, ell=ell),
                           tprep.postings(sim, tau, ell))


def test_build_postings_empty_and_degenerate_collections():
    for sets, pad in (([[]], 4), ([[5, 9]], 4), ([[], [3], []], 2)):
        jprep = jengine.prepare(jfrom_lists(sets, pad_to=pad))
        tprep = tengine.prepare(tfrom_lists(sets, pad_to=pad), device="cpu")
        for sim, tau in SIM_TAUS:
            ref = jpostings.build_postings(jprep, sim, tau)
            got = tpostings.build_postings(tprep, sim, tau)
            _assert_same_index(ref, got)
            assert got.as_dict() == ref.as_dict()


def test_postings_cached_per_key_and_per_device():
    tprep = tengine.prepare(tfrom_lists(_sets("uniform", seed=3), pad_to=_PAD),
                            device="cpu")
    p1 = tprep.postings("jaccard", 0.8)
    assert tprep.postings("jaccard", 0.8) is p1 and tprep.builds["postings"] == 1
    tprep.postings("jaccard", 0.8, ell=2)
    tprep.postings("cosine", 0.8)
    assert tprep.builds["postings"] == 3
    arrays = p1.device_arrays("cpu")
    assert p1.device_arrays("cpu") is arrays
    assert all(a.dtype.itemsize == 4 and a.is_contiguous() for a in arrays)
    assert np.array_equal(arrays[5].numpy(), p1.post_key)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sim,tau", SIM_TAUS)
def test_indexed_self_join_matches_reference(kind, sim, tau):
    cj, ct = _both(_sets(kind, seed=len(kind) * 11 + int(tau * 10)))
    ref = jindexed(cj, sim, tau, **_KW)
    got = tindexed(ct, sim, tau, device="cpu", **_KW)
    _assert_same(ref, got, (kind, sim))
    assert np.array_equal(got[0], jjoin.naive_join(cj, sim, tau))
    assert got[1].overflow_blocks == 0 and got[1].blocks_total == 6


def test_indexed_driver_on_an_index_built_by_the_reference():
    """The JAX package's postings index and words carried over as numpy:
    same join as the port's own artifacts, and nothing is rebuilt."""
    cj, ct = _both(_sets("skewed", seed=9))
    jprep = jengine.prepare(cj)
    post = jprep.postings("jaccard", 0.7)
    words = {(32, "xor", False): jprep.bitmap_words_np(32, "xor")}
    carried = tengine.prepared_from_numpy(cj.tokens, cj.lengths, words=words,
                                          postings=[post], device="cpu")
    assert carried.postings("jaccard", 0.7) is not post
    _assert_same_index(post, carried.postings("jaccard", 0.7))
    own = tengine.prepare(ct, device="cpu")
    kw = dict(sim="jaccard", tau=0.7, b=32, probe_block=16, return_stats=True)
    _assert_same(tcand.indexed_join_prepared(own, **kw),
                 tcand.indexed_join_prepared(carried, **kw), "carried")
    assert carried.builds["postings"] == 0 and carried.builds["bitmap"] == 0
    with pytest.raises(ValueError, match="carried postings"):
        tengine.prepared_from_numpy(cj.tokens[:5], cj.lengths[:5], postings=[post],
                                    device="cpu")


def test_chunk_step_spec_runs_the_first_chunk():
    """The reified first chunk gives the reference's first-chunk counts."""
    from repro.index import candidates as jcand

    cj, ct = _both(_sets("uniform", seed=12))
    kw = dict(sim="jaccard", tau=0.6, b=32, probe_block=16)
    jargs, jstat = jcand.chunk_step_spec(jengine.prepare(cj), **kw)
    targs, tstat = tcand.chunk_step_spec(tengine.prepare(ct, device="cpu"), **kw)
    assert {k: v for k, v in tstat.items() if k != "table"} == jstat
    want = jcand._indexed_chunk_step(*jargs, **jstat)
    got = tcand._indexed_chunk_step(*targs, **tstat)
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]
    k = int(got[4])
    assert np.array_equal(got[0][:k].numpy(), np.asarray(want[0])[:k])
    with pytest.raises(ValueError, match="degenerate"):
        tcand.chunk_step_spec(tengine.prepare(tfrom_lists([[]], pad_to=4), device="cpu"))


def test_stage_masks_match_reference():
    """``verdict_and_verify(return_masks=True)`` — the serving layer's per-slot
    masks — over the stages composed by hand, against the reference's."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.index import candidates as jcand

    cj, ct = _both(_sets("dup_heavy", seed=13))
    kw = dict(sim="jaccard", tau=0.6, b=32, probe_block=16)
    jargs, js = jcand.chunk_step_spec(jengine.prepare(cj), **kw)
    targs, ts = tcand.chunk_step_spec(tengine.prepare(ct, device="cpu"), **kw)

    def run(mod, args, st, arange, s0):
        rr, ss, _ = mod.expand_and_filter(
            *args[5:9], *args[3:5], args[9], args[10], *args[12:15], s0,
            sim=st["sim"], tau=st["tau"], cap=st["cap"], lp=st["lp"],
            scale=st["scale"], self_join=st["self_join"], impl=st["impl"])
        cr, cs, n_gen = mod.dedup_pairs(rr, ss, st["cap"])
        slot_ok = arange(st["cap"]) < n_gen
        return mod.verdict_and_verify(
            *args[0:3], args[9], args[10], args[11], cr, cs, slot_ok, args[15], s0,
            sim=st["sim"], tau=st["tau"], cutoff=st["cutoff"], impl=st["impl"],
            return_masks=True)

    want = jax.jit(lambda *a: run(jcand, a, js, jnp.arange, a[16]))(*jargs)
    got = run(tcand, targs, ts, torch.arange, 0)
    for w, g in zip(want[1:], got[1:]):
        assert np.array_equal(np.asarray(w), g.numpy())
    k = int(got[2])
    assert k > 0 and np.array_equal(np.asarray(want[0])[:k], got[0][:k].numpy())


def test_empty_inputs_and_mismatched_devices():
    ct = tfrom_lists(_sets("uniform", seed=1), pad_to=_PAD)
    empty = tfrom_lists([[]], pad_to=_PAD)
    for args in ((empty,), (ct, empty), (empty, ct)):
        pairs, stats = tindexed(*args, "jaccard", 0.8, device="cpu", **_KW)
        assert pairs.shape == (0, 2) and stats.total_pairs == 0
    prep = tengine.prepare(ct, device="cpu")
    other = tengine.prepare(tfrom_lists([[1, 2]]), device="meta")
    with pytest.raises(ValueError, match="prepared on"):
        tcand.indexed_join_prepared(prep, other, sim="jaccard", tau=0.5)
