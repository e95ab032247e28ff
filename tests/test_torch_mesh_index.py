"""The port's sharded-indexed driver and the mesh-aware engine and store on
its plans, against the JAX package's on meshes of 1, 2 and 4 devices,
exactly.

The JAX package runs on 4 fake CPU devices in one process; the port on 4
gloo ranks (``_torch_mesh``), its 1- and 2-shard meshes as the ``data``
axis of a (4, 1) and a (2, 2) mesh, its 4 shards on a (4,) mesh and, as a
composite axis, on all of a (2, 2) mesh.  Every case compares pairs and
summed ``JoinStats`` with the reference's and with the port's own
single-device ``indexed`` driver, with no tolerance:

* self-joins across four similarities on 4 shards, and on 1 and 2, and
  R×S; the collection-level ``sharded_indexed_bitmap_join`` on the
  composite axis;
* forced capacities that escalate chunks to the dense fallback;
* a hot slab (a Zipf-hot token universe no cut can balance);
* ``JoinEngine`` with a mesh under a sharded-indexed plan (no fallback),
  and ``CorpusStore`` with a mesh (append, self-join, probe, ``compact``);
* every rank's results equal rank 0's.
"""

import numpy as np
import pytest

import _torch_mesh as tm

SIMS = [("jaccard", 0.6), ("cosine", 0.8), ("dice", 0.8), ("overlap", 3.0)]
# (sim, tau, shards) of the self-joins, and (sim, tau, capacity) of the
# forced-capacity runs on 4 shards.
SELF_CASES = [("jaccard", 0.6, 1), ("jaccard", 0.6, 2), ("jaccard", 0.6, 4),
              ("cosine", 0.8, 2), ("cosine", 0.8, 4), ("dice", 0.8, 4), ("overlap", 3.0, 4)]
CAP_CASES = [("jaccard", 0.6, 1), ("cosine", 0.8, 5)]

_CASES = r"""
from _torch_mesh import hot_sets, planted_sets, probe_sets, stats_row
SIMS, SELF_CASES, CAP_CASES = %r, %r, %r
SETS = planted_sets(500, 21)
PROBE = probe_sets(SETS, 150, 22)
HOT = hot_sets(400, 23)
BASE, DELTA = planted_sets(300, 24), planted_sets(70, 25)
STORE_PROBE = probe_sets(BASE, 90, 27)
KW = dict(b=32, probe_block=128, return_stats=True)

def put(key, out):
    RES[key + "_pairs"], RES[key + "_stats"] = out[0], stats_row(out[1])
""" % (SIMS, SELF_CASES, CAP_CASES)

_PORT = tm.PORT_PRELUDE + _CASES + r"""
from repro_torch.core.collection import from_lists
from repro_torch.core.engine import JoinEngine, prepare
from repro_torch.core.plan import JoinPlan
from repro_torch.distributed import sharded_indexed_join_prepared as sharded
from repro_torch.index import indexed_join_prepared
from repro_torch.store import CorpusStore

meshes = {1: (make_mesh((4, 1), ("pod", "data"), "cpu"), "data"),
          2: (make_mesh((2, 2), ("pod", "data"), "cpu"), "data"),
          4: (make_mesh((4,), ("data",), "cpu"), "data")}
prep = prepare(from_lists(SETS, pad_to=16), "cpu")
probe = prepare(from_lists(PROBE, pad_to=16), "cpu")
for sim, tau in SIMS:
    put(f"single_{sim}_{tau}", indexed_join_prepared(prep, sim=sim, tau=tau, **KW))
for sim, tau, n in SELF_CASES:
    mesh, axis = meshes[n]
    put(f"self_{sim}_{tau}_{n}", sharded(prep, mesh=mesh, axis=axis, sim=sim, tau=tau, **KW))
for sim, tau, cap in CAP_CASES:
    put(f"cap_{sim}_{tau}_{cap}", sharded(prep, mesh=meshes[4][0], axis="data", sim=sim,
                                          tau=tau, capacity=cap, **KW))
    put(f"single_cap_{sim}_{tau}_{cap}",
        indexed_join_prepared(prep, sim=sim, tau=tau, capacity=cap, **KW))
put("rs", sharded(prep, probe, mesh=meshes[4][0], axis="data", sim="jaccard", tau=0.6, **KW))
put("single_rs", indexed_join_prepared(prep, probe, sim="jaccard", tau=0.6, **KW))
from repro_torch.distributed import sharded_indexed_bitmap_join
put("composite", sharded_indexed_bitmap_join(from_lists(SETS, pad_to=16), "jaccard", 0.6,
                                             mesh=meshes[2][0], device="cpu", **KW))
RES["builds"] = np.array([prep.builds["postings"], prep.builds["sharded_postings"]])
hot = prepare(from_lists(HOT, pad_to=16), "cpu")
put("hot", sharded(hot, mesh=meshes[4][0], axis="data", sim="jaccard", tau=0.6, **KW))
put("single_hot", indexed_join_prepared(hot, sim="jaccard", tau=0.6, **KW))
RES["hot_counts"] = hot.sharded_postings("jaccard", 0.6, 1, 4).counts

mesh = meshes[4][0]
plan = JoinPlan(driver="sharded-indexed", sim="jaccard", tau=0.8, b=32, block=128)
eng = JoinEngine(from_lists(SETS, pad_to=16), "jaccard", 0.8, plan=plan, mesh=mesh,
                 axis="data", device="cpu")
put("eng_self", eng.self_join(return_stats=True))
put("eng_probe", eng.probe(from_lists(PROBE, pad_to=16)))
RES["eng_fallbacks"] = np.array(len(eng.fallbacks))

store = CorpusStore(from_lists(BASE, pad_to=16), "jaccard", 0.6,
                    plan=JoinPlan(driver="sharded-indexed", sim="jaccard", tau=0.6, b=32,
                                  block=128), mesh=mesh, axis="data", device="cpu")
store.append(from_lists(DELTA, pad_to=16), compact=False)
for name in ("store", "compacted"):
    put(name + "_self", store.self_join(return_stats=True))
    put(name + "_probe", store.probe(from_lists(STORE_PROBE, pad_to=16)))
    RES[name + "_fallbacks"] = np.array(sum(len(seg.engine(store).fallbacks)
                                            for seg in store.segments()))
    store.compact()
""" + tm.PORT_EPILOGUE

_REF = tm.REF_PRELUDE + _CASES + r"""
from repro.core import join
from repro.core.collection import from_lists
from repro.core.engine import JoinEngine, prepare
from repro.core.plan import JoinPlan
from repro.distributed.sharded_index import sharded_indexed_join_prepared as sharded
from repro.store import CorpusStore

meshes = {n: make_mesh((n,), ("data",)) for n in (1, 2, 4)}
col = from_lists(SETS, pad_to=16)
prep, probe = prepare(col), prepare(from_lists(PROBE, pad_to=16))
for sim, tau in SIMS:
    RES[f"naive_{sim}_{tau}"] = join.naive_join(col, sim, tau)
for sim, tau, n in SELF_CASES:
    put(f"self_{sim}_{tau}_{n}", sharded(prep, mesh=meshes[n], axis="data", sim=sim,
                                         tau=tau, **KW))
for sim, tau, cap in CAP_CASES:
    put(f"cap_{sim}_{tau}_{cap}", sharded(prep, mesh=meshes[4], axis="data", sim=sim,
                                          tau=tau, capacity=cap, **KW))
put("rs", sharded(prep, probe, mesh=meshes[4], axis="data", sim="jaccard", tau=0.6, **KW))
put("composite", sharded(prep, mesh=make_mesh((2, 2), ("pod", "data")), sim="jaccard",
                         tau=0.6, **KW))
hot = prepare(from_lists(HOT, pad_to=16))
put("hot", sharded(hot, mesh=meshes[4], axis="data", sim="jaccard", tau=0.6, **KW))

plan = JoinPlan(driver="sharded-indexed", sim="jaccard", tau=0.8, b=32, block=128)
eng = JoinEngine(col, "jaccard", 0.8, plan=plan, mesh=meshes[4], axis="data")
put("eng_self", eng.self_join(return_stats=True))
put("eng_probe", eng.probe(from_lists(PROBE, pad_to=16)))
RES["eng_fallbacks"] = np.array(len(eng.fallbacks))

store = CorpusStore(from_lists(BASE, pad_to=16), "jaccard", 0.6,
                    plan=JoinPlan(driver="sharded-indexed", sim="jaccard", tau=0.6, b=32,
                                  block=128), mesh=meshes[4], axis="data")
store.append(from_lists(DELTA, pad_to=16), compact=False)
for name in ("store", "compacted"):
    put(name + "_self", store.self_join(return_stats=True))
    put(name + "_probe", store.probe(from_lists(STORE_PROBE, pad_to=16)))
    store.compact()
""" + tm.REF_EPILOGUE


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_index")
    procs = [tm.start_reference(_REF, out / "ref.npz"), *tm.start_port(_PORT, out)]
    tm.wait(procs)
    return tm.load(out)


def _same(ref, port, key, want_key=None):
    for part in ("_pairs", "_stats"):
        want, got = ref[(want_key or key) + part], port[key + part]
        assert got.shape == want.shape and np.array_equal(got, want), (key + part, got, want)


def test_every_rank_returns_the_same(results):
    _, ports = results
    for rank in ports[1:]:
        assert rank.keys() == ports[0].keys()
        for key in ports[0]:
            assert np.array_equal(rank[key], ports[0][key]), key


@pytest.mark.parametrize("sim,tau,n_shards", SELF_CASES)
def test_sharded_self_join_matches_reference_and_indexed(results, sim, tau, n_shards):
    ref, (port, *_) = results
    key = f"self_{sim}_{tau}_{n_shards}"
    _same(ref, port, key)
    _same(port, port, key, f"single_{sim}_{tau}")
    assert np.array_equal(port[key + "_pairs"], ref[f"naive_{sim}_{tau}"])
    assert len(port[key + "_pairs"]) > 0


@pytest.mark.parametrize("sim,tau,cap", CAP_CASES)
def test_forced_capacity_escalates_as_the_reference(results, sim, tau, cap):
    ref, (port, *_) = results
    key = f"cap_{sim}_{tau}_{cap}"
    _same(ref, port, key)
    _same(port, port, key, f"single_{key}")
    assert port[key + "_stats"][5] > 0          # overflow_blocks
    assert np.array_equal(port[key + "_pairs"], ref[f"naive_{sim}_{tau}"])


@pytest.mark.parametrize("case", ["rs", "composite", "hot"])
def test_rs_composite_axis_and_hot_slab(results, case):
    ref, (port, *_) = results
    _same(ref, port, case)
    if case != "composite":
        _same(port, port, case, "single_" + case)
    if case == "hot":
        counts = port["hot_counts"]
        assert counts.max() >= 2 * max(int(counts.min()), 1), counts
    # one CSR index per (sim, tau), one partition per shard count of each
    assert port["builds"].tolist() == [len(SIMS), len(SELF_CASES)]


@pytest.mark.parametrize("what", ["eng_self", "eng_probe"])
def test_engine_with_a_mesh_runs_sharded_indexed(results, what):
    ref, (port, *_) = results
    _same(ref, port, what)
    assert int(port["eng_fallbacks"]) == 0 == int(ref["eng_fallbacks"])


@pytest.mark.parametrize("state", ["store", "compacted"])
@pytest.mark.parametrize("what", ["self", "probe"])
def test_store_with_a_mesh_matches_reference(results, state, what):
    ref, (port, *_) = results
    _same(ref, port, f"{state}_{what}")
    assert int(port[state + "_fallbacks"]) == 0
