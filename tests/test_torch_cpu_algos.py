"""The port's CPU algorithms, Bitmap Filter and the engine's CPU plans
against the JAX package's, on the CPU.

* AllPairs, PPJoin, GroupJoin and AdaptJoin (``cpu_algos.ALGORITHMS``) give
  the reference's pairs and every ``AlgoStats`` counter over the grid: 4
  similarities × τ ∈ {0.5, 0.6, 0.8, 0.95} × uniform / skewed / dup-heavy
  collections × self-join and R×S, without the filter and with each of the
  Set, Xor, Next and Combined methods, from ``Collection`` and from
  ``PreparedCollection`` inputs.  Exact: no tolerance.
* ``BitmapFilter.build`` / ``build_rs`` (words built by the port on the
  CPU) give the reference's ``uint32`` words, cutoff and method, and the
  same ``prune_mask`` over every pair; the three mask functions agree.
* The three ``expected.py`` functions the port added equal the reference's
  exactly (the Monte-Carlo one from the same seed).
* ``JoinEngine`` under CPU plans (explicit, and the planner's
  ``prefer="cpu"``) gives the reference engine's pairs, ``JoinStats``, plan
  and prefix-index build count.
"""

import dataclasses
import functools
import zlib

import numpy as np
import pytest

from repro.core import cpu_algos as jalgos
from repro.core import engine as jengine
from repro.core import expected as jexpected
from repro.core import filters as jfilters
from repro.core import plan as jplan
from repro.core.collection import from_lists as jfrom_lists
from repro_torch.core import cpu_algos as talgos
from repro_torch.core import engine as tengine
from repro_torch.core import expected as texpected
from repro_torch.core import filters as tfilters
from repro_torch.core import plan as tplan
from repro_torch.core.collection import from_lists as tfrom_lists

ALGOS = sorted(jalgos.ALGORITHMS)
SIMS = ("jaccard", "cosine", "dice", "overlap")
TAUS = (0.5, 0.6, 0.8, 0.95)
KINDS = ("uniform", "skewed", "dup_heavy")
MODES = ("self", "rs")
METHODS = (None, "set", "xor", "next", "combined")   # None: no filter
_PAD = 12
_B = 64


def _threshold(sim: str, tau: float) -> float:
    """Overlap takes an absolute count: the τ grid maps onto {4..8}."""
    return float(max(1, round(tau * 8))) if sim == "overlap" else tau


def _sets(kind: str, rng, n: int, universe: int = 110):
    if kind == "uniform":
        return [rng.choice(universe, size=rng.integers(1, 13),
                           replace=False).tolist() for _ in range(n)]
    if kind == "skewed":
        sets = []
        for _ in range(n):
            sz = int(rng.integers(1, 13))
            toks = np.unique(np.minimum(rng.zipf(1.3, size=3 * sz + 4),
                                        universe + 30))[:sz]
            sets.append(toks.tolist())
        return sets
    base = [rng.choice(universe, size=rng.integers(2, 13),
                       replace=False).tolist() for _ in range(max(n // 4, 1))]
    sets = []
    for _ in range(n):
        src = base[int(rng.integers(len(base)))]
        kept = [t for t in src if rng.random() > 0.15]
        sets.append(kept or src[:1])
    return sets


@functools.lru_cache(maxsize=None)
def _lists(kind: str, mode: str):
    """R (and S) as lists, with planted exact and near duplicates, so every
    family joins at τ = 0.95 too."""
    rng = np.random.default_rng(zlib.crc32(f"torch:{kind}:{mode}".encode()))
    sets_r = _sets(kind, rng, 48)
    for k in range(0, 12, 3):
        sets_r[k + 1] = list(sets_r[k])
        if len(sets_r[k]) > 2:
            sets_r[k + 2] = list(sets_r[k][:-1])
    if mode == "self":
        return sets_r, None
    sets_s = _sets(kind, rng, 32)
    for k in range(4):
        sets_s[k] = list(sets_r[3 * k])
    return sets_r, sets_s


@functools.lru_cache(maxsize=None)
def _cols(pkg: str, kind: str, mode: str):
    from_lists = jfrom_lists if pkg == "jax" else tfrom_lists
    sets_r, sets_s = _lists(kind, mode)
    return (from_lists(sets_r, pad_to=_PAD),
            None if sets_s is None else from_lists(sets_s, pad_to=_PAD))


@functools.lru_cache(maxsize=None)
def _prepared(pkg: str, kind: str, mode: str):
    col_r, col_s = _cols(pkg, kind, mode)
    prep = jengine.prepare if pkg == "jax" else functools.partial(tengine.prepare,
                                                                  device="cpu")
    return prep(col_r), None if col_s is None else prep(col_s)


@functools.lru_cache(maxsize=None)
def _filter(pkg, sim, tau, kind, mode, method, prepared):
    if method is None:
        return None
    if prepared:
        prep_r, prep_s = _prepared(pkg, kind, mode)
        build = (jengine if pkg == "jax" else tengine).prepared_bitmap_filter
        return build(prep_r, prep_s, sim=sim, tau=tau, b=_B, method=method)
    col_r, col_s = _cols(pkg, kind, mode)
    cls = jfilters.BitmapFilter if pkg == "jax" else tfilters.BitmapFilter
    kw = {} if pkg == "jax" else {"device": "cpu"}
    if col_s is None:
        return cls.build(col_r.tokens, col_r.lengths, sim, tau, b=_B, method=method, **kw)
    return cls.build_rs(col_r.tokens, col_r.lengths, col_s.tokens, col_s.lengths,
                        sim, tau, b=_B, method=method, **kw)


def _run(pkg, algo, sim, tau, kind, mode, method, prepared):
    mod = jalgos if pkg == "jax" else talgos
    r, s = (_prepared if prepared else _cols)(pkg, kind, mode)
    stats = mod.AlgoStats()
    pairs = mod.ALGORITHMS[algo](r, s, sim, tau, stats=stats,
                                 bitmap=_filter(pkg, sim, tau, kind, mode, method, prepared))
    return pairs, dataclasses.asdict(stats)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("algo", ALGOS)
def test_algorithm_matches_reference(algo, sim, mode):
    """One algorithm × one similarity × one join mode over τ × collections ×
    filters × input kinds (120 runs a side): pairs and AlgoStats identical."""
    found = pruned = 0
    for tau in TAUS:
        th = _threshold(sim, tau)
        for kind in KINDS:
            for method in METHODS:
                for prepared in (False, True):
                    cell = (algo, sim, th, kind, mode, method, prepared)
                    want = _run("jax", *cell)
                    got = _run("torch", *cell)
                    assert got[0].dtype == want[0].dtype == np.int64, cell
                    assert np.array_equal(got[0], want[0]), cell
                    assert got[1] == want[1], (cell, got[1], want[1])
                    found += len(got[0])
                    pruned += got[1]["bitmap_pruned"]
    assert found > 0 and pruned > 0, (found, pruned)


@pytest.mark.parametrize("b", [32, 64, 128])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", ["set", "xor", "next", "combined"])
def test_bitmap_filter_matches_reference(method, mode, b):
    for sim, tau in (("jaccard", 0.5), ("jaccard", 0.8), ("cosine", 0.6), ("dice", 0.95),
                     ("overlap", 5.0)):
        for use_cutoff, mix in ((True, False), (False, True)):
            kw = dict(b=b, method=method, use_cutoff=use_cutoff, mix=mix)
            jr, js = _cols("jax", "dup_heavy", mode)
            tr, ts = _cols("torch", "dup_heavy", mode)
            if js is None:
                want = jfilters.BitmapFilter.build(jr.tokens, jr.lengths, sim, tau, **kw)
                got = tfilters.BitmapFilter.build(tr.tokens, tr.lengths, sim, tau, **kw,
                                                  device="cpu")
            else:
                want = jfilters.BitmapFilter.build_rs(jr.tokens, jr.lengths, js.tokens,
                                                      js.lengths, sim, tau, **kw)
                got = tfilters.BitmapFilter.build_rs(tr.tokens, tr.lengths, ts.tokens,
                                                     ts.lengths, sim, tau, **kw, device="cpu")
            for a, w in ((got.words, want.words), (got.probe_words, want.probe_words)):
                assert a.dtype == w.dtype == np.uint32 and np.array_equal(a, w)
            assert (got.cutoff, got.method, got.b) == (want.cutoff, want.method, want.b)
            assert np.array_equal(got.lengths, want.lengths)
            assert np.array_equal(got.probe_lengths, want.probe_lengths)
            js_all = np.arange(len(got.lengths))
            for i in range(len(got.probe_lengths)):
                assert np.array_equal(got.hamming(i, js_all), want.hamming(i, js_all))
                assert np.array_equal(got.prune_mask(i, js_all), want.prune_mask(i, js_all))
            assert got.prune_mask(0, np.zeros((0,), np.int64)).shape == (0,)


@pytest.mark.parametrize("mode", MODES)
def test_prepared_bitmap_filter_matches_reference(mode):
    jr, js = _prepared("jax", "uniform", mode)
    tr, ts = _prepared("torch", "uniform", mode)
    for method in ("set", "xor", "next", "combined"):
        for sim, tau in (("jaccard", 0.6), ("cosine", 0.8)):
            want = jengine.prepared_bitmap_filter(jr, js, sim=sim, tau=tau, b=_B,
                                                  method=method)
            got = tengine.prepared_bitmap_filter(tr, ts, sim=sim, tau=tau, b=_B,
                                                 method=method)
            assert np.array_equal(got.words, want.words)
            assert np.array_equal(got.probe_words, want.probe_words)
            assert (got.cutoff, got.method) == (want.cutoff, want.method)
    # The numpy words are the device words' bit patterns, built once per key.
    assert tr.builds["bitmap"] == 3
    words = tr.bitmap_words_np(_B, "xor")
    assert words.dtype == np.uint32
    assert np.array_equal(words.view(np.int32), tr.bitmap_words(_B, "xor").numpy())
    assert np.array_equal(words, jr.bitmap_words_np(_B, "xor"))
    assert tr.bitmap_words_np(_B, "combined", tau=0.6) is tr.bitmap_words_np(
        _B, tengine.bm.choose_method(0.6, _B))
    with pytest.raises(ValueError, match="needs tau"):
        tr.bitmap_words_np(_B, "combined")
    assert tr.sorted_collection is tr.sorted_collection
    assert np.array_equal(tr.sorted_collection.tokens, jr.sorted_collection.tokens)


@pytest.mark.parametrize("sim", SIMS)
def test_mask_functions_match_reference(sim):
    lens = np.arange(0, 40)
    lr, ls = np.meshgrid(lens, lens, indexing="ij")
    pos = np.arange(0, 12)
    for tau in TAUS:
        th = _threshold(sim, tau)
        for a, b in zip(tfilters.length_window(sim, th, lens),
                        jfilters.length_window(sim, th, lens)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(tfilters.length_filter_mask(sim, th, lr, ls),
                              jfilters.length_filter_mask(sim, th, lr, ls))
        for pr in pos:
            ps = pos[::-1]
            got = tfilters.positional_filter_mask(sim, th, lr[..., None], ls[..., None], pr, ps)
            want = jfilters.positional_filter_mask(sim, th, lr[..., None], ls[..., None], pr, ps)
            assert np.array_equal(got, want)
    from repro.core import bounds as jbounds
    from repro_torch.core import bounds as tbounds

    o = np.minimum(lr, ls) // 2
    with np.errstate(divide="ignore", invalid="ignore"):
        assert np.array_equal(tbounds.similarity(sim, o, lr, ls),
                              jbounds.similarity(sim, o, lr, ls), equal_nan=True)
    ham = (lr * 7 + ls * 3) % 17
    assert np.array_equal(tbounds.overlap_upper_bound(lr, ls, ham),
                          jbounds.overlap_upper_bound(lr, ls, ham))
    assert tbounds.positional_upper_bound(9, 7, 2, 3) == jbounds.positional_upper_bound(9, 7, 2, 3)
    with pytest.raises(ValueError, match="unknown similarity"):
        tbounds.similarity("hamming", 1, 2, 3)


def test_expected_functions_match_reference():
    for b in (32, 64, 128, 1024):
        assert texpected.combined_crossovers_normalized(b) == \
            jexpected.combined_crossovers_normalized(b)
        for n in (1, 5, 17, 40):
            assert texpected.expected_bound_xor_sum(b, n) == jexpected.expected_bound_xor_sum(b, n)
    for method in ("set", "xor", "next"):
        for b, n, seed in ((64, 10, 0), (128, 33, 3)):
            want = jexpected.monte_carlo_expected_bound(method, b, n, trials=300, seed=seed)
            got = texpected.monte_carlo_expected_bound(method, b, n, trials=300, seed=seed,
                                                       device="cpu")
            assert got == want, (method, b, n)


def _engine_pair(plan_kw, kind, mode, tau, sim="jaccard"):
    (jr, js), (tr, ts) = _cols("jax", kind, mode), _cols("torch", kind, mode)
    ref = jengine.JoinEngine(jr, sim, tau, plan=jplan.JoinPlan(sim=sim, tau=tau, **plan_kw))
    port = tengine.JoinEngine(tr, sim, tau, device="cpu",
                              plan=tplan.JoinPlan(sim=sim, tau=tau, **plan_kw))
    return ref, port, js, ts


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("driver", ALGOS)
def test_engine_cpu_plans_match_reference(driver, mode):
    for kind, tau, b, method in (("dup_heavy", 0.6, 64, "combined"),
                                 ("uniform", 0.5, 32, "next"), ("skewed", 0.8, 128, "xor")):
        ref, port, js, ts = _engine_pair(dict(driver=driver, b=b, method=method),
                                         kind, mode, tau)
        assert port.plan.to_dict() == ref.plan.to_dict()
        for _ in range(3):
            if js is None:
                want, got = (e.self_join(return_stats=True) for e in (ref, port))
            else:
                want, got = ref.probe(js), port.probe(ts)
            assert np.array_equal(got[0], want[0]), (driver, kind, mode)
            assert got[1].to_dict() == want[1].to_dict(), (driver, kind, mode)
        # GroupJoin indexes its groups, not the prepared prefix index.
        assert (port.prepared.builds["prefix_index"] == ref.prepared.builds["prefix_index"]
                == (driver != "groupjoin"))
        assert port.prepared.build_counts()["bitmap"] == ref.prepared.builds["bitmap"]
        assert port.stats_summary() == ref.stats_summary()
        assert port.fallbacks == ref.fallbacks == []


@pytest.mark.parametrize("sim,tau", [("jaccard", 0.5), ("jaccard", 0.8), ("cosine", 0.6),
                                     ("overlap", 4.0)])
def test_engine_planned_cpu_driver_matches_reference(sim, tau):
    jr, js = _cols("jax", "uniform", "rs")
    tr, ts = _cols("torch", "uniform", "rs")
    kw = dict(prefer="cpu", backend="cpu", n_devices=1)
    ref = jengine.JoinEngine(jr, sim, tau, plan=jplan.JoinPlanner().plan(sim, tau, 48, **kw))
    port = tengine.JoinEngine(tr, sim, tau, device="cpu",
                              plan=tplan.JoinPlanner().plan(sim, tau, 48, **kw))
    assert port.plan.to_dict() == ref.plan.to_dict()
    assert port.plan.driver in ("ppjoin", "adaptjoin")
    for want, got in ((ref.self_join(return_stats=True), port.self_join(return_stats=True)),
                      (ref.probe(js), port.probe(ts)),
                      (ref.probe(jengine.prepare(js)), port.probe(tengine.prepare(ts, "cpu")))):
        assert np.array_equal(got[0], want[0])
        assert got[1].to_dict() == want[1].to_dict()
    assert port.prepared.build_counts() == {k: ref.prepared.builds[k]
                                            for k in port.prepared.build_counts()}
