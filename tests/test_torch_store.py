"""The port's corpus store against the JAX package's, on the CPU.

The append -> probe -> compact schedule of ``tests/test_store.py`` (three
appends, one compaction, a probe and a self-join at every state) runs on
both stores side by side, at a few hundred sets: jaccard and cosine,
τ ∈ {0.6, 0.85}, b = 128 (``impl="ref"``) and b = 1024 (the bit-plane plain
versions, ``impl="ref_mxu"``), blocked and indexed plans.  Pairs, the summed
``JoinStats``, ``StoreStats`` and the build counters must be identical, and
the sealed base must not be rebuilt by an append.  A store carried over
from the JAX package's segments (``store_from_numpy``) must give the same
results as the port's own, without rebuilding what it carried.
"""

import numpy as np
import pytest

from repro.core.plan import JoinPlan as JJoinPlan
from repro.store import CompactionPolicy as JCompactionPolicy
from repro.store import CorpusStore as JCorpusStore
from repro_torch.core import engine as tengine
from repro_torch.core.bitmap import choose_method
from repro_torch.core.plan import JoinPlan as TJoinPlan
from repro_torch.serve import JoinSession
from repro_torch.store import CompactionPolicy, CorpusStore, merge_pairs, sum_stats
from test_torch_join import _both, _sets

_BLOCK = 64


def _plans(driver, sim, tau, b, impl):
    kw = dict(driver=driver, sim=sim, tau=tau, b=b, block=_BLOCK, impl=impl,
              compaction="host" if driver == "blocked" else "device")
    return JJoinPlan(**kw), TJoinPlan(**kw)


def _same(ref, got, what):
    (rp, rs), (gp, gs) = ref, got
    assert gp.dtype == np.int64 and np.array_equal(rp, gp), (what, len(rp), len(gp))
    assert rs.to_dict() == gs.to_dict(), (what, rs, gs)


def _same_store_stats(jstore, tstore):
    j, t = jstore.stats().to_dict(), tstore.stats().to_dict()
    for key in ("builds", "delta_builds", "lifetime_builds"):
        jb, tb = j.pop(key), t.pop(key)
        # Counters of the reference that the port lacks stay 0 on this path.
        assert {k: jb.get(k, 0) for k in tb} == tb, (key, jb, tb)
        assert all(v == 0 for k, v in jb.items() if k not in tb), (key, jb)
    assert j == t


def _delta(i):
    return _both(_sets("dup_heavy", seed=20 + i, n=64))


# Each driver at both widths, each similarity and threshold twice (the JAX
# side compiles per shape and capacity, which sets the budget).
SCHEDULES = [("blocked", "jaccard", 0.6, 128, "ref"),
             ("blocked", "cosine", 0.85, 1024, "ref_mxu"),
             ("indexed", "jaccard", 0.6, 1024, "ref_mxu"),
             ("indexed", "cosine", 0.85, 128, "ref")]


@pytest.mark.parametrize("driver,sim,tau,b,impl", SCHEDULES)
def test_schedule_matches_reference_at_every_state(driver, sim, tau, b, impl):
    jplan, tplan = _plans(driver, sim, tau, b, impl)
    jbase, tbase = _both(_sets("dup_heavy", seed=7, n=192))
    jstore = JCorpusStore(jbase, sim, tau, plan=jplan, policy=JCompactionPolicy.never())
    tstore = CorpusStore(tbase, sim, tau, plan=tplan, policy=CompactionPolicy.never(),
                         device="cpu")
    jbatch, tbatch = _both(_sets("dup_heavy", seed=99, n=64))

    def check(state):
        _same(jstore.probe(jbatch), tstore.probe(tbatch), f"probe {state}")
        _same(jstore.self_join(return_stats=True), tstore.self_join(return_stats=True),
              f"self-join {state}")
        _same_store_stats(jstore, tstore)

    check("base")
    base_builds = tstore.builds()
    assert base_builds["sort"] == 1 and base_builds["bitmap"] == 1
    for i in range(3):
        jd, td = _delta(i)
        jseg, tseg = jstore.append(jd, compact=False), tstore.append(td, compact=False)
        assert tseg.offset == jseg.offset
        check(f"delta {i}")
        assert tstore.builds() == base_builds  # the sealed base is never rebuilt
    assert tstore.compact() and jstore.compact()
    assert tstore.base_version == 1 and not tstore.deltas
    check("compacted")
    # And the port's store against a from-scratch rebuild under its plan.
    oracle = tengine.JoinEngine(tengine.prepare(tstore.collection(), "cpu"), sim, tau,
                                plan=tplan, device="cpu")
    assert np.array_equal(oracle.probe(tbatch)[0], tstore.probe(tbatch)[0])


@pytest.mark.parametrize("driver,b,impl", [("blocked", 1024, "ref_mxu"), ("indexed", 128, "ref")])
def test_store_carried_from_the_reference(driver, b, impl):
    """``store_from_numpy`` over the JAX store's segments: the same joins as
    a store the port built itself, and nothing carried is rebuilt."""
    sim, tau = "jaccard", 0.7
    jplan, tplan = _plans(driver, sim, tau, b, impl)
    jbase, tbase = _both(_sets("skewed", seed=3, n=150))
    jstore = JCorpusStore(jbase, sim, tau, plan=jplan, policy=JCompactionPolicy.never())
    own = CorpusStore(tbase, sim, tau, plan=tplan, policy=CompactionPolicy.never(),
                      device="cpu")
    for i in range(2):
        jd, td = _delta(i)
        jstore.append(jd, compact=False)
        own.append(td, compact=False)
    jstore.self_join()  # builds the segments' words (and postings)
    method = choose_method(tau, b)
    segments = []
    for seg in jstore.segments():
        prep = seg.prepared
        segments.append(dict(
            tokens=np.asarray(prep.source.tokens), lengths=np.asarray(prep.source.lengths),
            offset=seg.offset, postings=list(prep._postings.values()),
            words={(b, method, False): prep.bitmap_words_np(b, method)}))
    carried = tengine.store_from_numpy(segments, sim, tau, plan=tplan, device="cpu")
    assert [s.offset for s in carried.segments()] == [s.offset for s in own.segments()]
    _same(own.self_join(return_stats=True), carried.self_join(return_stats=True), "self-join")
    jbatch, tbatch = _both(_sets("skewed", seed=5, n=30))
    _same(own.probe(tbatch), carried.probe(tbatch), "probe")
    _same(jstore.probe(jbatch), carried.probe(tbatch), "probe vs reference")
    lifetime = carried.stats().lifetime_builds
    assert lifetime["bitmap"] == 0 and lifetime["postings"] == 0
    with pytest.raises(ValueError, match="contiguous"):
        tengine.store_from_numpy(segments[1:], sim, tau, plan=tplan, device="cpu")


def test_engine_and_session_adopt_a_store():
    """A store corpus drops in wherever a prepared corpus did: the engine
    and the session adopt its plan, sim, τ and device."""
    sim, tau = "cosine", 0.7
    _, tplan = _plans("indexed", sim, tau, 1024, "ref_mxu")
    _, tbase = _both(_sets("dup_heavy", seed=1, n=120))
    store = CorpusStore(tbase, sim, tau, plan=tplan, device="cpu")
    store.append(_delta(0)[1], compact=False)
    eng = tengine.JoinEngine(store)
    assert (eng.plan, eng.sim, eng.tau, eng.device.type) == (tplan, sim, tau, "cpu")
    assert eng.prepared is store.base.prepared
    _, batch = _both(_sets("dup_heavy", seed=2, n=20))
    _same(store.probe(batch), eng.probe(batch), "engine probe")
    _same(store.self_join(return_stats=True), eng.self_join(return_stats=True), "self-join")
    store.compact()
    assert eng.prepared is store.base.prepared  # reads through to the live base
    sess = JoinSession(store, max_batch=8, max_wait=0.0)
    assert sess.plan == tplan and sess.device.type == "cpu"
    _same(store.probe(batch), sess.probe(batch), "session probe")
    for bad in (dict(plan=TJoinPlan(driver="blocked", sim=sim, tau=tau)),
                dict(sim="jaccard", tau=0.5), dict(device="meta")):
        with pytest.raises(ValueError):
            tengine.JoinEngine(store, **bad)


def test_policy_sum_stats_and_merge_pairs():
    policy = CompactionPolicy(max_deltas=2, size_ratio=0.5)
    assert not policy.should_compact(100, [])
    assert not policy.should_compact(100, [10])
    assert policy.should_compact(100, [10, 10])
    assert policy.should_compact(100, [51])
    assert not CompactionPolicy.never().should_compact(1, [10**6] * 100)
    for bad in (dict(max_deltas=0), dict(size_ratio=0.0)):
        with pytest.raises(ValueError):
            CompactionPolicy(**bad)
    got = merge_pairs([np.array([[3, 1], [0, 2]]), np.zeros((0, 2)), np.array([[0, 1]])])
    assert got.dtype == np.int64 and got.tolist() == [[0, 1], [0, 2], [3, 1]]
    assert merge_pairs([]).shape == (0, 2)
    _, tbase = _both(_sets("dup_heavy", seed=1, n=60))
    store = CorpusStore(tbase, "jaccard", 0.7, device="cpu",
                        policy=CompactionPolicy(max_deltas=2, size_ratio=10.0))
    store.append(_delta(0)[1])
    assert store.compactions == 0
    store.append(_delta(1)[1])  # the policy fires on the second delta
    assert store.compactions == 1 and not store.deltas and store.num_sets == 188
    _, st1 = store.self_join(return_stats=True)
    total = sum_stats([st1, st1])
    assert total.verified_true == 2 * st1.verified_true
