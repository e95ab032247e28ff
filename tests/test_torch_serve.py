"""The port's serving layer against the JAX package's, on the CPU.

The load-bearing property is coalescing exactness: any interleaving and
grouping of probe requests through ``JoinSession`` (merged batches,
sequential fallbacks, forced-capacity overflows, empty requests) yields,
per request, the pairs and ``JoinStats`` of probing that request alone.
The sweep runs the same request streams and flush cadences through the
port's session and the JAX package's, at b = 128 (``impl="auto"``, the
plain versions on the CPU) and b = 1024 (the bit-plane plain versions,
``impl="ref_mxu"``), and holds every ticket to the JAX session's ticket and
to a solo ``JoinEngine.probe``.  Then the build-once contract across
warm-up and ``append``, and unit tests of the coalescer, ``pow2_bucket``,
the entrypoint cache, the transfer pool and the min-overlap table cache
mirroring ``tests/test_serve.py``.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.core.collection import from_lists as jfrom_lists
from repro.core.plan import JoinPlan as JJoinPlan
from repro.serve import JoinSession as JJoinSession
from repro_torch.core import verify
from repro_torch.core.collection import from_lists as tfrom_lists
from repro_torch.core.engine import JoinEngine, prepare
from repro_torch.core.plan import JoinPlanner
from repro_torch.serve import (
    EntrypointCache,
    JoinSession,
    RequestCoalescer,
    TransferPool,
    pow2_bucket,
)

SIM, TAU = "jaccard", 0.7
_PAD = 12  # one padded width: stable bucket shapes across examples
WIDTHS = [(128, "auto"), (1024, "ref_mxu")]


def _corpus_sets(seed: int = 3, n: int = 250):
    """Dup-heavy corpus: near-copies give real pairs and, under a forced
    tiny capacity, solo-probe overflows."""
    rng = np.random.default_rng(seed)
    base = [rng.choice(140, size=rng.integers(3, 11), replace=False).tolist()
            for _ in range(30)]
    sets = []
    for _ in range(n):
        src = base[int(rng.integers(len(base)))]
        sets.append([t for t in src if rng.random() > 0.2] or src[:1])
    return sets


def _request_sets(seed: int, corpus_sets):
    """A mixed request stream: singletons, small batches, empty requests
    and exact corpus rows (certain matches)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(3, 9))):
        sets = []
        for _ in range(int(rng.integers(0, 5))):
            if rng.random() < 0.5:
                sets.append(list(corpus_sets[int(rng.integers(len(corpus_sets)))]))
            else:
                sets.append(rng.choice(140, size=int(rng.integers(1, 11)),
                                       replace=False).tolist())
        out.append(sets)
    return out


CORPUS = _corpus_sets()


class _Pair:
    """A port session and the JAX session on the same corpus and plan."""

    def __init__(self, b, impl, capacity=None):
        self.tsess = JoinSession(tfrom_lists(CORPUS, pad_to=_PAD), SIM, TAU,
                                 planner=JoinPlanner(b=b, impl=impl), max_batch=16,
                                 max_wait=0.0, device="cpu")
        if capacity is not None:
            plan = dataclasses.replace(self.tsess.plan, capacity=capacity)
            self.tsess = JoinSession(tfrom_lists(CORPUS, pad_to=_PAD), SIM, TAU,
                                     plan=plan, max_batch=16, max_wait=0.0, device="cpu")
        plan = self.tsess.plan
        jplan = JJoinPlan(**{**plan.to_dict(), "reasons": plan.reasons})
        self.jsess = JJoinSession(jfrom_lists(CORPUS, pad_to=_PAD), SIM, TAU, plan=jplan,
                                  max_batch=16, max_wait=0.0)
        self.oracle = JoinEngine(prepare(tfrom_lists(CORPUS, pad_to=_PAD), "cpu"), SIM, TAU,
                                 plan=plan, device="cpu")

    def run(self, requests, flush_after):
        """Submit ``requests`` (lists of sets) to both sessions, flushing
        after the indices in ``flush_after`` and at the end; every ticket
        must equal the JAX session's and a solo probe."""
        tt, jt = [], []
        for i, sets in enumerate(requests):
            tt.append(self.tsess.submit(tfrom_lists(sets, pad_to=_PAD)))
            jt.append(self.jsess.submit(jfrom_lists(sets, pad_to=_PAD)))
            if i in flush_after:
                self.tsess.flush()
                self.jsess.flush()
        self.tsess.flush()
        self.jsess.flush()
        for t, j, sets in zip(tt, jt, requests):
            (tp, ts), (jp, js) = t.result(), j.result()
            assert t.route == j.route, (t.route, j.route)
            assert tp.dtype == np.int64 and np.array_equal(tp, jp), (t.route, len(sets))
            assert ts.to_dict() == js.to_dict(), (t.route, ts, js)
            op, os_ = self.oracle.probe(tfrom_lists(sets, pad_to=_PAD))
            assert np.array_equal(tp, op) and ts == os_, (t.route, ts, os_)
        return tt


@pytest.fixture(scope="module", params=WIDTHS, ids=["b128", "b1024"])
def pair(request):
    return _Pair(*request.param)


@pytest.fixture(scope="module", params=WIDTHS, ids=["b128", "b1024"])
def forced_pair(request):
    # A forced tiny capacity: requests whose solo probe would overflow the
    # chunk (dense-fallback escalation) must route sequentially.
    return _Pair(*request.param, capacity=48)


@pytest.mark.parametrize("seed", range(4))
def test_coalescing_exactness_sweep(pair, seed):
    """Any request mix and flush cadence: every ticket equals the JAX
    session's and a solo probe."""
    rng = np.random.default_rng(seed + 1)
    requests = _request_sets(seed, CORPUS)
    flush_after = {i for i in range(len(requests)) if rng.random() < 0.35}
    pair.run(requests, flush_after)


@pytest.mark.parametrize("seed", range(2))
def test_coalescing_exactness_forced_overflow(forced_pair, seed):
    forced_pair.run(_request_sets(100 + seed, CORPUS), set())


def test_forced_overflow_actually_routes_sequentially(forced_pair):
    req = tfrom_lists(CORPUS[:8], pad_to=_PAD)
    n_exp, _lp = forced_pair.tsess._prepass(req)
    assert n_exp > 48  # the forced capacity
    (t,) = forced_pair.run([CORPUS[:8]], set())
    assert t.route == "sequential"
    assert t.stats.overflow_blocks >= 1  # the solo run escalated, and we match


@pytest.mark.parametrize("b,impl", WIDTHS)
def test_no_builds_after_warm_up_and_across_append(b, impl):
    sess = JoinSession(tfrom_lists(CORPUS, pad_to=_PAD), SIM, TAU,
                       planner=JoinPlanner(b=b, impl=impl), max_batch=16, max_wait=0.0,
                       device="cpu")
    sample = [tfrom_lists([s], pad_to=_PAD) for s in CORPUS[:8]]
    assert sess.warm_buckets(sample) >= 1
    warm = sess.entrypoints.stats()["traces"]
    for r in sample * 4:  # any grouping of the sampled shapes
        sess.submit(r)
    sess.flush()
    assert sess.entrypoints.stats()["traces"] == warm
    builds = sess.prepared.build_counts()
    sess.append(tfrom_lists(CORPUS[:20], pad_to=_PAD), compact=False)
    tickets = [sess.submit(r) for r in sample * 2]
    sess.flush()
    ep = sess.entrypoints.stats()
    assert ep["traces"] == warm and ep["max_traces_per_key"] == 1
    assert sess.prepared.build_counts() == builds  # the base is not rebuilt
    assert all(t.route == "coalesced" for t in tickets)
    for t, r in zip(tickets, sample * 2):  # base ∪ delta, as the store probes it
        p, s = t.result()
        sp, ss = sess.store.probe(r)
        assert np.array_equal(p, sp) and s == ss
    assert sess.compact() and not sess.compact()
    assert sess.store.base_version == 1 and sess.prepared.num_sets == len(CORPUS) + 20
    p, s = sess.probe(sample[0])
    assert np.array_equal(p, sess.store.probe(sample[0])[0])


def test_session_probe_and_stats_summary(pair):
    req = tfrom_lists(CORPUS[:3], pad_to=_PAD)
    pairs, stats = pair.tsess.probe(req)
    want_pairs, want_stats = pair.oracle.probe(req)
    assert np.array_equal(pairs, want_pairs) and stats == want_stats
    assert pair.tsess.probe(req, return_stats=False).shape == pairs.shape
    s = pair.tsess.stats_summary()
    for key in ("engine", "entrypoints", "transfer", "min_overlap_cache", "requests",
                "coalesced_requests", "sequential_requests", "coalesced_batches",
                "pad_overhead", "builds"):
        assert key in s, key
    assert s["builds"]["sort"] == 1 and s["builds"]["bitmap"] == 1
    assert s["requests"] == s["coalesced_requests"] + s["sequential_requests"]
    assert s["engine"]["probes"] == s["requests"] and s["pad_overhead"] >= 0.0
    assert s["transfer"]["uploads"] == s["coalesced_batches"]


def test_session_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JoinSession(tfrom_lists(CORPUS[:10], pad_to=_PAD), SIM, TAU)


# ---------------------------------------------------------------------------
# Component units: coalescer, entrypoint cache, transfer pool, table cache
# ---------------------------------------------------------------------------

def _req(rows: int):
    return tfrom_lists([[1 + i, 2 + i, 3 + i] for i in range(rows)], pad_to=4)


def test_coalescer_due_policy():
    c = RequestCoalescer(max_batch=4, max_wait=1.0)
    assert not c.due(now=0.0)
    c.submit(_req(1), now=0.0)
    assert not c.due(now=0.5)      # neither full nor aged
    assert c.due(now=1.0)          # the oldest hit max_wait
    c.submit(_req(3), now=0.1)
    assert c.due(now=0.2)          # a full batch is pending
    assert c.pending_rows == 4


def test_coalescer_drain_grouping():
    c = RequestCoalescer(max_batch=4, max_wait=0.0)
    tickets = [c.submit(_req(r)) for r in [2, 1, 2, 4, 6, 1]]
    groups = c.drain()
    # FIFO first fit: [2,1] | [2] (4 won't fit) | [4] | [6 oversized] | [1]
    assert [[t.rows for t in g] for g in groups] == [[2, 1], [2], [4], [6], [1]]
    assert [t.seq for g in groups for t in g] == [t.seq for t in tickets]
    assert len(c) == 0 and c.drained_groups == 5


def test_coalescer_validation():
    with pytest.raises(ValueError):
        RequestCoalescer(max_batch=0)
    with pytest.raises(ValueError):
        RequestCoalescer(max_wait=-1.0)
    t = RequestCoalescer().submit(_req(1))
    with pytest.raises(RuntimeError):
        t.result()


def test_pow2_bucket():
    assert [pow2_bucket(n) for n in (0, 1, 2, 3, 5, 16, 17)] == [1, 1, 2, 4, 8, 16, 32]
    assert pow2_bucket(3, floor=16) == 16
    assert pow2_bucket(100, floor=16) == 128


def test_entrypoint_cache_builds_once_and_counts():
    cache = EntrypointCache(maxsize=2)
    built = []

    def mk(key):
        def build():
            built.append(key)
            cache.note_trace(key)   # the session records each build
            return lambda: key
        return build

    a = cache.get("a", mk("a"))
    assert cache.get("a", mk("a")) is a and a() == "a"
    assert built == ["a"]
    s = cache.stats()
    assert s["traces"] == 1 and s["max_traces_per_key"] == 1 and s["hits"] == 1
    cache.get("b", mk("b"))
    cache.get("c", mk("c"))   # evicts "a" (LRU, maxsize=2)
    s = cache.stats()
    assert s["entries"] == 2 and s["misses"] == 3 and s["hits"] == 1
    assert built == ["a", "b", "c"]
    cache.get("a", mk("a"))   # rebuilt after eviction
    assert built == ["a", "b", "c", "a"] and cache.stats()["traces"] == 4
    cache.clear()
    assert cache.stats() == {"entries": 0, "hits": 0, "misses": 0, "traces": 0,
                             "max_traces_per_key": 0}


def test_transfer_pool_reuses_buffers():
    pool = TransferPool(depth=2, device="cpu")
    arrays = [np.arange(6, dtype=np.int32).reshape(2, 3), np.ones(2, dtype=np.int32)]
    uploaded = []
    for i in range(5):
        dev = pool.upload("k", [a + i for a in arrays])
        assert dev[0].dtype == torch.int32 and np.array_equal(dev[0].numpy(), arrays[0] + i)
        uploaded.append(dev)
    # No batch aliases a later one's staging slot.
    assert [int(d[1][0]) for d in uploaded] == [1, 2, 3, 4, 5]
    s = pool.stats()
    assert s["uploads"] == 5 and s["buckets"] == 1
    assert s["slot_builds"] == 2  # the ring filled once, then reused
    assert s["staged_bytes"] == 5 * (6 + 2) * 4
    # A signature change (the bucket widened) rebuilds the ring.
    pool.upload("k", [np.zeros((4, 3), np.int32), np.ones(4, np.int32)])
    assert pool.stats()["slot_builds"] == 3
    with pytest.raises(ValueError):
        TransferPool(depth=0)


def test_transfer_pool_defaults_to_the_card():
    """Like every entry point of the port, the pool runs on the card unless
    asked for the CPU: without one, the default raises naming device='cpu'."""
    if torch.cuda.is_available():
        assert TransferPool().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TransferPool()
    pool = TransferPool(device="cpu")
    assert pool.device == torch.device("cpu") and pool.depth == 3
    assert pool.upload("k", [np.ones(2, np.int32)])[0].device.type == "cpu"


def test_min_overlap_cache_locked_and_counted():
    verify._TABLE_CACHE.clear()
    assert verify.min_overlap_cache_stats()["entries"] == 0
    errs = []

    def hammer():
        try:
            for i in range(20):
                verify.min_overlap_table_dev(SIM, TAU, 16 + (i % 3), 16, "cpu")
        except Exception as e:  # pragma: no cover - failure capture
            errs.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    verify.prune_table_dev(SIM, TAU, 16, 16, "cpu")  # another kind: not counted
    s = verify.min_overlap_cache_stats()
    assert s["entries"] == 3
    assert s["hits"] + s["misses"] == 6 * 20 and s["misses"] >= 3
    t1 = verify.min_overlap_table_dev(SIM, TAU, 16, 16, "cpu")
    assert verify.min_overlap_table_dev(SIM, TAU, 16, 16, "cpu") is t1
