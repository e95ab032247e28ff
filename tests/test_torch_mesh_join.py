"""The port's ring join, mesh, planner and mesh-aware engine and store
against the JAX package's on a 4-device mesh, exactly.

The JAX package runs on 4 fake CPU devices in one process; the port on 4
gloo ranks (``_torch_mesh``).  Every case compares, with no tolerance:

* ``ring_join_sharded``: ``valid``, ``pairs[valid]``, per-device counters
  and per-step overflow flags, self-join and R×S, with and without a
  capacity that overflows;
* ``ring_join`` across four similarities at τ ∈ {0.6, 0.8} (overlap: 3
  and 5 tokens) with capacities that force the dense re-runs: pairs,
  reconciled counters and flags, and the pairs of ``naive_join``;
* ``ring_join_prepared`` on a self-join and R×S whose sizes do not divide
  by 4 (pairs, counters, flags; the words built once);
* ``JoinEngine`` with a mesh under a ring plan (self-join and a probe, no
  fallback) and ``CorpusStore`` with a mesh (append, self-join, probe,
  ``compact``);
* the planner's default device count with a process group (its world
  size) and without one;
* every rank's results equal rank 0's;
* in this process, ``partition_postings`` / ``shard_expansion_counts`` on
  1, 2, 3, 4 and 8 shards, a hot slab included, and the engine's
  fallbacks without a mesh.
"""

import numpy as np
import pytest

import _torch_mesh as tm
from repro.core import engine as jengine
from repro.core.collection import from_lists as jfrom_lists
from repro.index import postings as jpostings
from repro.index.candidates import probe_prefix_lengths as jprobe_prefix_lengths
from repro_torch.core import engine as tengine
from repro_torch.core import join as tjoin
from repro_torch.core import plan as tplan
from repro_torch.core.collection import from_lists as tfrom_lists
from repro_torch.index import postings as tpostings
from repro_torch.index.candidates import probe_prefix_lengths as tprobe_prefix_lengths

# (sim, tau) of the ring cases, and the capacities each runs at.
RING_CASES = [("jaccard", 0.6), ("jaccard", 0.8), ("cosine", 0.6), ("cosine", 0.8),
              ("dice", 0.6), ("dice", 0.8), ("overlap", 3.0), ("overlap", 5.0)]
RING_CAPS = [0, 4]          # 0: the default capacity

_CASES = r"""
from _torch_mesh import planted_sets, probe_sets, stats_row
RING_CASES = %r
RING_CAPS = %r
SETS = planted_sets(400, 1)
SETS_R, SETS_S = planted_sets(320, 2), probe_sets(planted_sets(320, 2), 200, 3)
ODD_R, ODD_S = planted_sets(402, 4), probe_sets(planted_sets(402, 4), 226, 5)
BASE, DELTA1, DELTA2 = planted_sets(300, 6), planted_sets(62, 7), planted_sets(50, 8)
PROBE = probe_sets(BASE, 90, 9)
""" % (RING_CASES, RING_CAPS)

_PORT = tm.PORT_PRELUDE + _CASES + r"""
from repro_torch.core import bitmap as bm, join
from repro_torch.core.collection import from_lists
from repro_torch.core.engine import JoinEngine, prepare
from repro_torch.core.plan import JoinPlan, JoinPlanner
from repro_torch.store import CorpusStore

mesh = make_mesh((4,), ("data",), device_type="cpu")

def arrays(sets):
    col = from_lists(sets, pad_to=16)
    tok, ln = torch.from_numpy(col.tokens.copy()), torch.from_numpy(col.lengths.copy())
    return col, tok, ln, bm.generate_bitmaps(tok, ln, 64, method="xor")

col, tok, ln, words = arrays(SETS)
for sim, tau in RING_CASES:
    for cap in RING_CAPS:
        key = f"{sim}_{tau}_{cap}"
        if (sim, tau) in (("jaccard", 0.6), ("cosine", 0.8)):
            p, v, c, o = join.ring_join_sharded(tok, ln, words, mesh=mesh, axis="data",
                                                sim=sim, tau=tau,
                                                capacity_per_step=cap or None)
            RES.update({"sh_pairs_" + key: p[v], "sh_valid_" + key: v,
                        "sh_counters_" + key: c, "sh_overflow_" + key: o})
        p, c, o = join.ring_join(tok, ln, words, mesh=mesh, axis="data", sim=sim, tau=tau,
                                 capacity_per_step=cap or None, return_stats=True)
        RES.update({"ring_pairs_" + key: p, "ring_counters_" + key: c,
                    "ring_overflow_" + key: o})
_, tr, lr, wr = arrays(SETS_R)
_, ts, ls, ws = arrays(SETS_S)
for cap in RING_CAPS:
    p, v, c, o = join.ring_join_sharded(tr, lr, wr, tokens_s=ts, lengths_s=ls, words_s=ws,
                                        mesh=mesh, axis="data", sim="jaccard", tau=0.6,
                                        capacity_per_step=cap or None)
    RES.update({f"rs_sh_pairs_{cap}": p[v], f"rs_sh_valid_{cap}": v,
                f"rs_sh_counters_{cap}": c, f"rs_sh_overflow_{cap}": o})
    p, c, o = join.ring_join(tr, lr, wr, tokens_s=ts, lengths_s=ls, words_s=ws, mesh=mesh,
                             axis="data", sim="jaccard", tau=0.6,
                             capacity_per_step=cap or None, return_stats=True)
    RES.update({f"rs_pairs_{cap}": p, f"rs_counters_{cap}": c})

pr = prepare(from_lists(ODD_R, pad_to=16), "cpu")
ps = prepare(from_lists(ODD_S, pad_to=16), "cpu")
for k in range(2):
    p, c, o = join.ring_join_prepared(pr, ps, mesh=mesh, axis="data", sim="jaccard", tau=0.6,
                                      b=64, method="xor", return_stats=True)
RES.update(prep_rs_pairs=p, prep_rs_counters=c, prep_rs_overflow=o,
           prep_builds=np.array([pr.builds["bitmap"], ps.builds["bitmap"]]))
p, c, o = join.ring_join_prepared(pr, mesh=mesh, axis="data", sim="jaccard", tau=0.8, b=64,
                                  method="xor", capacity_per_step=4, return_stats=True)
RES.update(prep_self_pairs=p, prep_self_counters=c, prep_self_overflow=o)

plan = JoinPlan(driver="ring", sim="jaccard", tau=0.8, b=64, method="xor")
eng = JoinEngine(from_lists(SETS, pad_to=16), "jaccard", 0.8, plan=plan, mesh=mesh,
                 axis="data", device="cpu")
p, s = eng.self_join(return_stats=True)
RES.update(eng_self_pairs=p, eng_self_stats=stats_row(s))
p, s = eng.probe(from_lists(PROBE, pad_to=16))
RES.update(eng_probe_pairs=p, eng_probe_stats=stats_row(s),
           eng_fallbacks=np.array(len(eng.fallbacks)))

store = CorpusStore(from_lists(BASE, pad_to=16), "jaccard", 0.6,
                    plan=JoinPlan(driver="ring", sim="jaccard", tau=0.6, b=64, method="xor"),
                    mesh=mesh, axis="data", device="cpu")
store.append(from_lists(DELTA1, pad_to=16), compact=False)
store.append(from_lists(DELTA2, pad_to=16), compact=False)
for name in ("store", "compacted"):
    p, s = store.self_join(return_stats=True)
    q, t = store.probe(from_lists(PROBE, pad_to=16))
    RES.update({name + "_self_pairs": p, name + "_self_stats": stats_row(s),
                name + "_probe_pairs": q, name + "_probe_stats": stats_row(t)})
    store.compact()
RES["store_fallbacks"] = np.array(sum(len(seg.engine(store).fallbacks)
                                      for seg in store.segments()))

planner = JoinPlanner()
RES["planner"] = np.array([
    planner.plan("jaccard", 0.8, n_r=100_000, backend="cpu").driver == "sharded-indexed",
    planner.plan("jaccard", 0.5, n_r=100_000, backend="cpu").driver == "ring"])
from repro_torch.core.plan import default_device_count
RES["device_count"] = np.array(default_device_count())
""" + tm.PORT_EPILOGUE

_REF = tm.REF_PRELUDE + _CASES + r"""
import jax.numpy as jnp
from repro.core import bitmap as bm, join
from repro.core.collection import from_lists
from repro.core.engine import JoinEngine, prepare
from repro.core.plan import JoinPlan
from repro.store import CorpusStore

mesh = make_mesh((4,), ("data",))

def arrays(sets):
    col = from_lists(sets, pad_to=16)
    tok, ln = jnp.asarray(col.tokens), jnp.asarray(col.lengths)
    return col, tok, ln, bm.generate_bitmaps(tok, ln, 64, method="xor")

col, tok, ln, words = arrays(SETS)
for sim, tau in RING_CASES:
    RES[f"naive_{sim}_{tau}"] = join.naive_join(col, sim, tau)
    for cap in RING_CAPS:
        key = f"{sim}_{tau}_{cap}"
        if (sim, tau) in (("jaccard", 0.6), ("cosine", 0.8)):
            p, v, c, o = (np.asarray(x) for x in join.ring_join_sharded(
                tok, ln, words, mesh=mesh, axis="data", sim=sim, tau=tau,
                capacity_per_step=cap or None))
            RES.update({"sh_pairs_" + key: p[v], "sh_valid_" + key: v,
                        "sh_counters_" + key: c, "sh_overflow_" + key: o})
        p, c, o = join.ring_join(tok, ln, words, mesh=mesh, axis="data", sim=sim, tau=tau,
                                 capacity_per_step=cap or None, return_stats=True)
        RES.update({"ring_pairs_" + key: p, "ring_counters_" + key: np.asarray(c),
                    "ring_overflow_" + key: np.asarray(o)})
cr, tr, lr, wr = arrays(SETS_R)
cs, ts, ls, ws = arrays(SETS_S)
RES["naive_rs"] = join.naive_join(cr, cs, "jaccard", 0.6)
for cap in RING_CAPS:
    p, v, c, o = (np.asarray(x) for x in join.ring_join_sharded(
        tr, lr, wr, tokens_s=ts, lengths_s=ls, words_s=ws, mesh=mesh, axis="data",
        sim="jaccard", tau=0.6, capacity_per_step=cap or None))
    RES.update({f"rs_sh_pairs_{cap}": p[v], f"rs_sh_valid_{cap}": v,
                f"rs_sh_counters_{cap}": c, f"rs_sh_overflow_{cap}": o})
    p, c, o = join.ring_join(tr, lr, wr, tokens_s=ts, lengths_s=ls, words_s=ws, mesh=mesh,
                             axis="data", sim="jaccard", tau=0.6,
                             capacity_per_step=cap or None, return_stats=True)
    RES.update({f"rs_pairs_{cap}": p, f"rs_counters_{cap}": np.asarray(c)})

cr, cs = from_lists(ODD_R, pad_to=16), from_lists(ODD_S, pad_to=16)
pr, ps = prepare(cr), prepare(cs)
p, c, o = join.ring_join_prepared(pr, ps, mesh=mesh, axis="data", sim="jaccard", tau=0.6,
                                  b=64, method="xor", return_stats=True)
RES.update(prep_rs_pairs=p, prep_rs_counters=np.asarray(c), prep_rs_overflow=np.asarray(o),
           naive_prep_rs=join.naive_join(cr, cs, "jaccard", 0.6))
p, c, o = join.ring_join_prepared(pr, mesh=mesh, axis="data", sim="jaccard", tau=0.8, b=64,
                                  method="xor", capacity_per_step=4, return_stats=True)
RES.update(prep_self_pairs=p, prep_self_counters=np.asarray(c),
           prep_self_overflow=np.asarray(o), naive_prep_self=join.naive_join(cr, "jaccard", 0.8))

plan = JoinPlan(driver="ring", sim="jaccard", tau=0.8, b=64, method="xor")
eng = JoinEngine(from_lists(SETS, pad_to=16), "jaccard", 0.8, plan=plan, mesh=mesh,
                 axis="data")
p, s = eng.self_join(return_stats=True)
RES.update(eng_self_pairs=p, eng_self_stats=stats_row(s))
p, s = eng.probe(from_lists(PROBE, pad_to=16))
RES.update(eng_probe_pairs=p, eng_probe_stats=stats_row(s),
           eng_fallbacks=np.array(len(eng.fallbacks)))

store = CorpusStore(from_lists(BASE, pad_to=16), "jaccard", 0.6,
                    plan=JoinPlan(driver="ring", sim="jaccard", tau=0.6, b=64, method="xor"),
                    mesh=mesh, axis="data")
store.append(from_lists(DELTA1, pad_to=16), compact=False)
store.append(from_lists(DELTA2, pad_to=16), compact=False)
for name in ("store", "compacted"):
    p, s = store.self_join(return_stats=True)
    q, t = store.probe(from_lists(PROBE, pad_to=16))
    RES.update({name + "_self_pairs": p, name + "_self_stats": stats_row(s),
                name + "_probe_pairs": q, name + "_probe_stats": stats_row(t)})
    store.compact()
""" + tm.REF_EPILOGUE


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_join")
    procs = [tm.start_reference(_REF, out / "ref.npz"), *tm.start_port(_PORT, out)]
    tm.wait(procs)
    return tm.load(out)


def _same(ref, port, key):
    want, got = ref[key], port[key]
    assert got.shape == want.shape and np.array_equal(got, want), (key, got, want)


def test_every_rank_returns_the_same(results):
    _, ports = results
    for rank in ports[1:]:
        assert rank.keys() == ports[0].keys()
        for key in ports[0]:
            assert np.array_equal(rank[key], ports[0][key]), key


@pytest.mark.parametrize("sim,tau", [("jaccard", 0.6), ("cosine", 0.8)])
@pytest.mark.parametrize("cap", RING_CAPS)
def test_ring_join_sharded_matches_reference(results, sim, tau, cap):
    ref, (port, *_) = results
    key = f"{sim}_{tau}_{cap}"
    for part in ("valid", "pairs", "counters", "overflow"):
        _same(ref, port, f"sh_{part}_{key}")
    if cap:
        assert port["sh_overflow_" + key].any()
    assert port["sh_counters_" + key].dtype == np.int64


@pytest.mark.parametrize("cap", RING_CAPS)
def test_ring_join_sharded_rs_matches_reference(results, cap):
    ref, (port, *_) = results
    for part in ("valid", "pairs", "counters", "overflow"):
        _same(ref, port, f"rs_sh_{part}_{cap}")
    _same(ref, port, f"rs_pairs_{cap}")
    _same(ref, port, f"rs_counters_{cap}")
    assert np.array_equal(port[f"rs_pairs_{cap}"], ref["naive_rs"])


@pytest.mark.parametrize("sim,tau", RING_CASES)
@pytest.mark.parametrize("cap", RING_CAPS)
def test_ring_join_matches_reference(results, sim, tau, cap):
    ref, (port, *_) = results
    key = f"{sim}_{tau}_{cap}"
    for part in ("pairs", "counters", "overflow"):
        _same(ref, port, f"ring_{part}_{key}")
    assert np.array_equal(port["ring_pairs_" + key], ref[f"naive_{sim}_{tau}"])
    assert port["ring_counters_" + key][:, 1].sum() == len(port["ring_pairs_" + key])


def test_ring_overflow_reruns_were_exercised(results):
    _, (port, *_) = results
    assert sum(port[f"ring_overflow_{s}_{t}_4"].sum() for s, t in RING_CASES) > 0


@pytest.mark.parametrize("kind", ["rs", "self"])
def test_ring_join_prepared_matches_reference(results, kind):
    ref, (port, *_) = results
    for part in ("pairs", "counters", "overflow"):
        _same(ref, port, f"prep_{kind}_{part}")
    assert np.array_equal(port[f"prep_{kind}_pairs"], ref[f"naive_prep_{kind}"])
    assert port["prep_builds"].tolist() == [1, 1]


@pytest.mark.parametrize("what", ["self", "probe"])
def test_engine_with_a_mesh_runs_the_ring(results, what):
    ref, (port, *_) = results
    _same(ref, port, f"eng_{what}_pairs")
    _same(ref, port, f"eng_{what}_stats")
    assert int(port["eng_fallbacks"]) == 0 == int(ref["eng_fallbacks"])


@pytest.mark.parametrize("state", ["store", "compacted"])
@pytest.mark.parametrize("what", ["self", "probe"])
def test_store_with_a_mesh_matches_reference(results, state, what):
    ref, (port, *_) = results
    _same(ref, port, f"{state}_{what}_pairs")
    _same(ref, port, f"{state}_{what}_stats")
    assert int(port["store_fallbacks"]) == 0


def test_planner_counts_the_world_as_devices(results, monkeypatch):
    _, (port, *_) = results
    assert port["planner"].tolist() == [True, True]
    assert int(port["device_count"]) == tm.WORLD
    # Without a process group: the cards this process sees.
    monkeypatch.setattr(tplan.torch.cuda, "device_count", lambda: 2)
    assert tplan.default_device_count() == 2
    assert tplan.JoinPlanner().plan("jaccard", 0.5, n_r=100_000,
                                    backend="cpu").driver == "ring"
    monkeypatch.setattr(tplan.torch.cuda, "device_count", lambda: 0)
    assert tplan.JoinPlanner().plan("jaccard", 0.5, n_r=100_000,
                                    backend="cpu").driver == "blocked"


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("data", ["planted", "hot"])
def test_partition_postings_matches_reference(n_shards, data):
    sets = tm.planted_sets(500, 11) if data == "planted" else tm.hot_sets(400, 12)
    jp = jengine.prepare(jfrom_lists(sets, pad_to=16))
    tp = tengine.prepare(tfrom_lists(sets, pad_to=16), "cpu")
    want = jp.sharded_postings("jaccard", 0.6, 1, n_shards)
    got = tp.sharded_postings("jaccard", 0.6, 1, n_shards)
    assert tp.sharded_postings("jaccard", 0.6, 1, n_shards) is got
    assert tp.builds["sharded_postings"] == 1 and tp.builds["postings"] == 1
    for f in ("slab_tid", "counts", "post_set", "post_pos", "post_len", "post_key"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.post_key.dtype == np.int32 and tpostings._KEY_SENTINEL == jpostings._KEY_SENTINEL
    ps, lp = tprobe_prefix_lengths(tp, "jaccard", 0.6)
    assert np.array_equal(ps, jprobe_prefix_lengths(jp, "jaccard", 0.6)[0])
    lo, hi, _, _ = tp.length_window_int("jaccard", 0.6)
    for c0 in range(0, tp.num_sets, 128):
        sl = slice(c0, c0 + 128)
        per = tpostings.shard_expansion_counts(got, tp.tokens[sl], ps[sl], lo[sl], hi[sl], lp)
        assert np.array_equal(per, jpostings.shard_expansion_counts(
            want, jp.tokens[sl], ps[sl], lo[sl], hi[sl], lp))
        cnt, _, valid = tpostings.lookup_counts_host(tp.postings("jaccard", 0.6),
                                                     tp.tokens[sl], ps[sl], lo[sl], hi[sl], lp)
        assert per.shape == (n_shards,) and per.sum() == cnt[valid].sum()
    slab = got.device_arrays("cpu", n_shards - 1)
    assert [a.tolist() for a in slab] == [getattr(got, f)[n_shards - 1].tolist() for f in
                                          ("post_set", "post_pos", "post_len", "post_key")]
    if data == "hot" and n_shards == 8:
        assert got.counts.max() >= 2 * max(int(got.counts.min()), 1), got.counts


def test_engine_without_a_mesh_falls_back():
    col = tfrom_lists(tm.planted_sets(200, 13), pad_to=16)
    for driver, fallback in (("ring", "blocked"), ("sharded-indexed", "indexed")):
        eng = tengine.JoinEngine(col, "jaccard", 0.6, device="cpu",
                                 plan=tplan.JoinPlan(driver=driver, sim="jaccard", tau=0.6))
        pairs = eng.self_join()
        assert eng.fallbacks == [f"{driver} plan without a mesh -> {fallback}"]
        assert np.array_equal(pairs, tjoin.naive_join(col, "jaccard", 0.6, device="cpu"))


@pytest.mark.parametrize("band", [7, 64, 1 << 28])
@pytest.mark.parametrize("cap", [1, 5, 40, 400])
def test_ring_compaction_by_bands_keeps_the_first_candidates(monkeypatch, band, cap):
    """The ring step counts and compacts its mask a row band at a time (a
    bool sum casts to int64 first): the first ``cap`` nonzeros in row-major
    order, zero-filled, and the count, whatever the bands."""
    import torch

    monkeypatch.setattr(tjoin, "_NONZERO_BAND", band)
    mask = torch.from_numpy(np.random.default_rng(cap + band).random((37, 11)) < 0.15)
    idx, n = tjoin._count_and_first_nonzero(mask, cap)
    assert torch.equal(idx, torch.nonzero_static(mask, size=cap, fill_value=0))
    assert int(n) == int(mask.sum())
