"""The port's planner and ``JoinEngine`` against the JAX package's, on the CPU.

* ``JoinPlanner.plan``/``serving_plan`` give plans whose ``to_dict()`` —
  reasons included — equals the reference's, across similarities, τ,
  sizes, ``prefer``, backend ∈ {cpu, gpu} and device counts {1, 4}.
* ``JoinEngine.probe``/``self_join`` give the reference engine's pairs and
  ``JoinStats`` under naive, blocked and indexed plans, with the same
  history, rollup, build counters and recorded fallbacks (a ring plan runs
  blocked, a sharded-indexed plan runs indexed).
* CPU-algorithm plans run, with the reference engine's pairs and
  ``JoinStats``, and a corpus store is adopted; without a card,
  ``backend=None`` and ``device=None`` raise.
"""

import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.core.collection import Collection as JCollection
from repro.core.collection import from_lists as jfrom_lists
from repro_torch.core import engine as tengine
from repro_torch.core import plan as tplan
from repro_torch.core.collection import Collection as TCollection
from repro_torch.core.collection import from_lists as tfrom_lists

SIM_TAUS = [("jaccard", 0.5), ("jaccard", 0.6), ("jaccard", 0.8), ("cosine", 0.55),
            ("cosine", 0.9), ("dice", 0.7), ("overlap", 3.0)]
SIZES = [(20, None), (20, 30), (5000, None), (6000, 7000), (102_000, None),
         (100_000, 4096)]
_PAD = 16


@pytest.mark.parametrize("n_devices", [1, 4])
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("sim,tau", SIM_TAUS)
def test_plans_match_reference(sim, tau, backend, n_devices):
    ref, port = jplan.JoinPlanner(), tplan.JoinPlanner()
    for n_r, n_s in SIZES:
        for prefer in ("auto", "device", "cpu"):
            kw = dict(prefer=prefer, backend=backend, n_devices=n_devices)
            want = ref.plan(sim, tau, n_r, n_s, **kw)
            got = port.plan(sim, tau, n_r, n_s, **kw)
            assert got.to_dict() == want.to_dict()
            assert got.describe() == want.describe() and got.to_json() == want.to_json()
        want = ref.serving_plan(sim, tau, n_r, backend=backend)
        assert port.serving_plan(sim, tau, n_r, backend=backend).to_dict() == want.to_dict()


def test_planner_knobs_and_validation_match_reference():
    knobs = dict(b=64, block=512, naive_cells=0, mix=True, use_cutoff=False,
                 impl="swar", indexed_cells=10, indexed_min_tau=0.7)
    ref, port = jplan.JoinPlanner(**knobs), tplan.JoinPlanner(**knobs)
    for sim, tau in SIM_TAUS:
        for kw in (dict(backend="gpu", n_devices=1), dict(backend="tpu", n_devices=8),
                   dict(backend="cpu", n_devices=1, b=256, block=64)):
            assert port.plan(sim, tau, 300, **kw).to_dict() == ref.plan(sim, tau, 300, **kw).to_dict()
    assert tplan.DRIVERS == jplan.DRIVERS and tplan.STORE_SUPPORT == jplan.STORE_SUPPORT
    bad = [dict(driver="warp"), dict(driver="blocked", b=48),
           dict(driver="blocked", compaction="gpu"), dict(driver="indexed", block=0),
           dict(driver="indexed", ell=0)]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            jplan.JoinPlan(sim="jaccard", tau=0.8, **kw)
        with pytest.raises(ValueError) as got:
            tplan.JoinPlan(sim="jaccard", tau=0.8, **kw)
        assert str(got.value) == str(want.value)
    cpu = dict(backend="cpu", n_devices=1)
    with pytest.raises(ValueError, match="n_r"):
        tplan.JoinPlanner().plan("jaccard", 0.8, 0, **cpu)
    with pytest.raises(ValueError, match="prefer"):
        tplan.JoinPlanner().plan("jaccard", 0.8, 10, prefer="quantum", **cpu)
    with pytest.raises(ValueError, match="tau must be positive"):
        tplan.JoinPlanner().plan("cosine", 0.0, 10, **cpu)
    with pytest.raises(ValueError, match="tau must be positive"):
        tplan.JoinPlanner().serving_plan("cosine", 0.0, 10, backend="cpu")


def test_backend_resolution_follows_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        tplan.JoinPlanner().plan("jaccard", 0.8, 5000)
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        tplan.JoinPlanner().serving_plan("jaccard", 0.8, 5000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    got = tplan.JoinPlanner().plan("jaccard", 0.8, 102_000)
    want = jplan.JoinPlanner().plan("jaccard", 0.8, 102_000, backend="gpu", n_devices=4)
    assert got.driver == "sharded-indexed" and got.to_dict() == want.to_dict()
    assert tplan.backend_of("cuda:0") == "gpu" and tplan.backend_of("cpu") == "cpu"
    with pytest.raises(ValueError, match="meta"):
        tplan.backend_of("meta")


# ---------------------------------------------------------------------------
# JoinEngine
# ---------------------------------------------------------------------------

def _sets(seed, n, universe=90):
    rng = np.random.default_rng(seed)
    base = [rng.choice(universe, size=rng.integers(2, 13), replace=False).tolist()
            for _ in range(max(n // 3, 1))]
    sets = []
    for _ in range(n):
        src = base[int(rng.integers(len(base)))]
        sets.append([t for t in src if rng.random() > 0.15] or src[:1])
    return sets


def _both(sets):
    return jfrom_lists(sets, pad_to=_PAD), tfrom_lists(sets, pad_to=_PAD)


def _split(col, cls, at):
    return (cls(tokens=col.tokens[:at], lengths=col.lengths[:at]),
            cls(tokens=col.tokens[at:], lengths=col.lengths[at:]))


def _assert_same(ref, got, what):
    (rp, rs), (gp, gs) = ref, got
    assert gp.dtype == np.int64 and np.array_equal(np.asarray(rp), gp), (what, len(rp), len(gp))
    assert rs.to_dict() == gs.to_dict(), (what, rs, gs)


def _engines(planner_kw, sim, tau, corpus_seed=1, plan_kw=None):
    cj, ct = _both(_sets(corpus_seed, 60))
    if plan_kw is None:
        return (jengine.JoinEngine(cj, sim, tau, planner=jplan.JoinPlanner(**planner_kw)),
                tengine.JoinEngine(ct, sim, tau, planner=tplan.JoinPlanner(**planner_kw),
                                   device="cpu"))
    want = jplan.JoinPlanner(**planner_kw).plan(sim, tau, cj.num_sets, **plan_kw)
    got = tplan.JoinPlanner(**planner_kw).plan(sim, tau, ct.num_sets, **plan_kw)
    assert got.to_dict() == want.to_dict()
    return (jengine.JoinEngine(cj, sim, tau, plan=want),
            tengine.JoinEngine(ct, sim, tau, plan=got, device="cpu"))


# (planner knobs, explicit plan arguments or None for the engine's own
# auto plan, the driver that must run, the fallback it must record)
ENGINE_CASES = [
    (dict(b=32), None, "naive", None),
    (dict(b=32, block=16, naive_cells=0), dict(backend="gpu", n_devices=1), "blocked", None),
    (dict(b=32, block=16, naive_cells=0, indexed_cells=0), dict(backend="gpu", n_devices=1),
     "indexed", None),
    (dict(b=32, block=16, naive_cells=0), dict(backend="gpu", n_devices=4), "ring", "blocked"),
    (dict(b=32, block=16, naive_cells=0, indexed_cells=0), dict(backend="gpu", n_devices=4),
     "sharded-indexed", "indexed"),
]


@pytest.mark.parametrize("planner_kw,plan_kw,driver,fallback", ENGINE_CASES)
def test_engine_matches_reference(planner_kw, plan_kw, driver, fallback):
    ref, port = _engines(planner_kw, "jaccard", 0.7, plan_kw=plan_kw)
    assert port.plan.driver == driver and port.plan.to_dict() == ref.plan.to_dict()
    sj, st = _both(_sets(2, 12 if driver == "naive" else 40))
    halves = zip(_split(sj, JCollection, 20), _split(st, TCollection, 20))
    for bj, bt in [(sj, st), *halves]:
        _assert_same(ref.probe(bj), port.probe(bt), driver)
    _assert_same(ref.self_join(return_stats=True), port.self_join(return_stats=True), driver)
    assert port.stats_summary() == ref.stats_summary()
    assert [s.to_dict() for s in port.history] == [s.to_dict() for s in ref.history]
    assert port.fallbacks == ref.fallbacks
    assert bool(port.fallbacks) == bool(fallback)
    if fallback:
        assert all(f.endswith("-> " + fallback) for f in port.fallbacks)
    jb, tb = ref.prepared.build_counts(), port.prepared.build_counts()
    assert {k: tb[k] for k in ("sort", "bitmap", "window", "postings")} == \
        {k: jb[k] for k in ("sort", "bitmap", "window", "postings")}


def test_engine_reuses_a_prepared_batch_and_caps_history():
    ref, port = _engines(dict(b=32, block=16, naive_cells=0, indexed_cells=0), "dice", 0.8,
                         plan_kw=dict(backend="gpu", n_devices=1))
    port_hist = tengine.JoinEngine(port.prepared, "dice", 0.8, plan=port.plan,
                                   history_limit=3)
    assert port_hist.device == torch.device("cpu")
    sj, st = _both(_sets(3, 30))
    pb = tengine.prepare(st, device="cpu")
    first = port.probe(pb)
    before = (port.prepared.build_counts(), pb.build_counts())
    _assert_same(ref.probe(sj), port.probe(pb), "prepared batch")
    assert (port.prepared.build_counts(), pb.build_counts()) == before
    assert port.prepared.builds["postings"] == 1
    seen = [port_hist.probe(st)[1] for _ in range(5)]
    assert port_hist.probes == 5 and list(port_hist.history) == seen[-3:]
    summary = port_hist.stats_summary()
    assert summary["history_len"] == 3 and summary["history_limit"] == 3
    assert summary["total_pairs"] == 5 * seen[0].total_pairs == 5 * first[1].total_pairs


def test_engine_naive_guard_escalates_like_reference():
    cj, ct = _both(_sets(4, 16))
    ref = jengine.JoinEngine(cj, "jaccard", 0.7, planner=jplan.JoinPlanner(b=32, naive_cells=600))
    port = tengine.JoinEngine(ct, "jaccard", 0.7, device="cpu",
                              planner=tplan.JoinPlanner(b=32, naive_cells=600))
    assert port.plan.driver == "naive" and port.plan.to_dict() == ref.plan.to_dict()
    for n in (20, 60):  # 320 cells stay naive, 960 escalate to blocked
        bj, bt = _both(_sets(5 + n, n))
        _assert_same(ref.probe(bj), port.probe(bt), n)
        assert port.fallbacks == ref.fallbacks
    assert len(port.fallbacks) == 1 and "blocked" in port.fallbacks[0]


def test_engine_refuses_what_is_not_ported():
    # The name predates the CPU algorithms' port: a CPU plan used to raise.
    # Now it runs, with the reference engine's pairs and JoinStats.
    cj, ct = _both(_sets(6, 30))
    kw = dict(prefer="cpu", backend="cpu", n_devices=1)
    ref = jengine.JoinEngine(cj, "jaccard", 0.5,
                             plan=jplan.JoinPlanner().plan("jaccard", 0.5, 30, **kw))
    engine = tengine.JoinEngine(ct, "jaccard", 0.5, device="cpu",
                                plan=tplan.JoinPlanner().plan("jaccard", 0.5, 30, **kw))
    assert engine.plan.to_dict() == ref.plan.to_dict() and engine.plan.driver == "adaptjoin"
    _assert_same(ref.probe(cj), engine.probe(ct), "cpu plan probe")
    _assert_same(ref.self_join(return_stats=True), engine.self_join(return_stats=True),
                 "cpu plan self-join")
    assert engine.prepared.builds["prefix_index"] == ref.prepared.builds["prefix_index"] == 1

    # A corpus store is ported too: the engine adopts its plan and device.
    from repro_torch.store import CorpusStore

    store = CorpusStore(ct, "jaccard", 0.5, device="cpu")
    adopted = tengine.JoinEngine(store)
    assert adopted.store is store and adopted.plan == store.plan
    assert adopted.device.type == "cpu" and adopted.prepared is store.base.prepared
    assert np.array_equal(adopted.self_join(), store.self_join())


def test_engine_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ct = tfrom_lists(_sets(7, 10), pad_to=_PAD)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.JoinEngine(ct, "jaccard", 0.8)
    engine = tengine.JoinEngine(ct, "jaccard", 0.8, device="cpu")
    assert engine.plan.compaction == "host" and engine.device.type == "cpu"
    # A prepared corpus brings its device along.
    assert tengine.JoinEngine(engine.prepared, "jaccard", 0.8).device.type == "cpu"
    with pytest.raises(ValueError, match="prepared on cpu"):
        tengine.JoinEngine(engine.prepared, "jaccard", 0.8, device="meta")
