"""The port's joins against the JAX package's, on the CPU.

Pairs and every ``JoinStats`` counter of ``repro_torch``'s
``blocked_bitmap_join`` must be identical to ``repro.core.join``'s, in both
compaction modes, with prepass-sized and forced capacities, for self-joins
and R×S; ``naive_join`` must be identical too.  The grid follows
``tests/test_oracle_differential.py`` (same collection kinds, b=32 and a
block of 16 rows, so every join walks several block pairs).

Both of the port's compaction modes are held against the reference's
device mode, whose pairs and stats the reference's own suite pins to its
host mode; the reference's host mode recompiles its verifier for every
candidate count, so it runs in one test here, to fit the time budget.
"""

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core import join as jjoin
from repro.core.collection import from_lists as jfrom_lists
from repro_torch.core import engine as tengine
from repro_torch.core import join as tjoin
from repro_torch.core.collection import from_lists as tfrom_lists

# One threshold per similarity (b = 32 picks Set at 0.5 and Xor at 0.7 and
# above); the JAX side compiles once per (sim, tau), which sets the budget.
SIM_TAUS = [("jaccard", 0.5), ("cosine", 0.7), ("dice", 0.85), ("overlap", 2.0)]
KINDS = ("uniform", "skewed", "dup_heavy")
_PAD = 16
_KW = dict(b=32, block=16, return_stats=True)


def _sets(kind, seed, n=48):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return [rng.choice(110, size=rng.integers(1, 13), replace=False).tolist()
                for _ in range(n)]
    if kind == "skewed":
        sets = []
        for _ in range(n):
            sz = int(rng.integers(1, 13))
            sets.append(np.unique(np.minimum(rng.zipf(1.3, size=3 * sz + 4), 140))[:sz].tolist())
        return sets
    base = [rng.choice(110, size=rng.integers(2, 13), replace=False).tolist()
            for _ in range(max(n // 4, 1))]
    sets = []
    for _ in range(n):
        src = base[int(rng.integers(len(base)))]
        sets.append([t for t in src if rng.random() > 0.15] or src[:1])
    return sets


def _both(sets):
    return jfrom_lists(sets, pad_to=_PAD), tfrom_lists(sets, pad_to=_PAD)


def _assert_same(ref, got, what):
    (rp, rs), (gp, gs) = ref, got
    assert gp.dtype == np.int64 and np.array_equal(rp, gp), (what, len(rp), len(gp))
    assert rs.to_dict() == gs.to_dict(), (what, rs, gs)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sim,tau", SIM_TAUS)
def test_self_join_matches_reference(kind, sim, tau):
    cj, ct = _both(_sets(kind, seed=len(kind) * 7 + int(tau * 100)))
    oracle = jjoin.naive_join(cj, sim, tau)
    assert np.array_equal(tjoin.naive_join(ct, sim, tau, device="cpu"), oracle)
    ref = jjoin.blocked_bitmap_join(cj, sim, tau, compaction="device", **_KW)
    assert np.array_equal(ref[0], oracle)
    for mode in ("host", "device"):
        got = tjoin.blocked_bitmap_join(ct, sim, tau, compaction=mode, device="cpu", **_KW)
        _assert_same(ref, got, mode)
    assert got[1].overflow_blocks == 0


@pytest.mark.parametrize("cap", [1, 2, 4, 8])
@pytest.mark.parametrize("sim,tau", [("jaccard", 0.5)])
def test_forced_capacity_overflow_matches_reference(cap, sim, tau):
    cj, ct = _both(_sets("dup_heavy", seed=cap))
    ref = jjoin.blocked_bitmap_join(cj, sim, tau, compaction="device", capacity=cap, **_KW)
    got = tjoin.blocked_bitmap_join(ct, sim, tau, compaction="device", capacity=cap,
                                    device="cpu", **_KW)
    _assert_same(ref, got, cap)
    assert got[1].overflow_blocks > 0
    assert np.array_equal(got[0], jjoin.naive_join(cj, sim, tau))


@pytest.mark.parametrize("cap", [None, 4])
@pytest.mark.parametrize("sim,tau", [("jaccard", 0.5), ("cosine", 0.7)])
def test_rs_join_matches_reference(cap, sim, tau):
    rng = np.random.default_rng(17)
    sets_r = _sets("uniform", seed=5)
    sets_s = [rng.choice(110, size=rng.integers(1, 13), replace=False).tolist()
              for _ in range(37)]
    for k in range(4):  # cross-collection duplicates -> non-trivial joins
        sets_s[k] = sets_r[3 * k]
    (rj, rt), (sj, st) = _both(sets_r), _both(sets_s)
    oracle = jjoin.naive_join(rj, sj, sim, tau)
    assert len(oracle) >= 4
    assert np.array_equal(tjoin.naive_join(rt, st, sim, tau, device="cpu"), oracle)
    ref = jjoin.blocked_bitmap_join(rj, sj, sim, tau, compaction="device", capacity=cap,
                                    **_KW)
    for mode in ("host", "device"):
        kw = dict(_KW, compaction=mode, capacity=cap if mode == "device" else None)
        got = tjoin.blocked_bitmap_join(rt, st, sim, tau, device="cpu", **kw)
        assert np.array_equal(ref[0], got[0]), (mode, cap)
        if mode == "device":
            _assert_same(ref, got, cap)


@pytest.mark.parametrize("method,mix", [("next", False), ("set", True)])
def test_methods_widths_and_ragged_blocks_match_reference(method, mix):
    """Each generation method, a wider bitmap, no cutoff, and a block size
    that does not divide the collection."""
    cj, ct = _both(_sets("skewed", seed=21, n=50))
    kw = dict(b=64, block=12, method=method, mix=mix, use_cutoff=False,
              compaction="device", return_stats=True)
    _assert_same(jjoin.blocked_bitmap_join(cj, "jaccard", 0.6, **kw),
                 tjoin.blocked_bitmap_join(ct, "jaccard", 0.6, device="cpu", **kw), method)


@pytest.mark.parametrize("use_bitmap", [True, False])
def test_host_compaction_matches_reference_host_compaction(use_bitmap):
    """The reference's own host mode, with and without the bitmap filter."""
    cj, ct = _both(_sets("uniform", seed=2))
    kw = dict(_KW, use_bitmap=use_bitmap, compaction="host")
    _assert_same(jjoin.blocked_bitmap_join(cj, "dice", 0.6, **kw),
                 tjoin.blocked_bitmap_join(ct, "dice", 0.6, device="cpu", **kw), use_bitmap)


@pytest.mark.parametrize("sim,tau", [("jaccard", 0.8), ("dice", 0.8), ("cosine", 0.75)])
def test_exactly_at_threshold_pairs(sim, tau):
    """Subset pairs whose similarity sits on (or within float ulps of) tau
    (|r| = 28 in |s| = 35 at Jaccard 0.8 is exactly at it): both compaction
    modes agree with the reference's float64 oracle."""
    sets = []
    for n in range(2, 40):
        base = list(range(1000 + n * 60, 1000 + n * 60 + n))
        sets.append(base)
        for extra in (1, 2, 3, 7):
            sets.append(base + list(range(7000 + n * 60, 7000 + n * 60 + extra)))
    cj, ct = jfrom_lists(sets), tfrom_lists(sets)
    oracle = jjoin.naive_join(cj, sim, tau)
    assert np.array_equal(tjoin.naive_join(ct, sim, tau, device="cpu"), oracle)
    for mode in ("host", "device"):
        got = tjoin.blocked_bitmap_join(ct, sim, tau, b=32, block=32, compaction=mode,
                                        device="cpu")
        assert np.array_equal(got, oracle), mode


def test_join_over_carried_words_matches_own_words():
    """Words built by the JAX package, carried over as numpy, give the same
    join as the port's own words, and are not rebuilt."""
    cj, ct = _both(_sets("dup_heavy", seed=8))
    jprep = jengine.prepare(cj)
    words = {(32, m, False): jprep.bitmap_words_np(32, m) for m in ("xor", "set")}
    carried = tengine.prepared_from_numpy(cj.tokens, cj.lengths, words=words, device="cpu")
    own = tengine.prepare(ct, device="cpu")
    for tau in (0.5, 0.85):  # Set at 0.5, Xor at 0.85 (b = 32)
        kw = dict(sim="jaccard", tau=tau, b=32, block=16, compaction="device",
                  return_stats=True)
        _assert_same(tjoin.blocked_bitmap_join_prepared(own, **kw),
                     tjoin.blocked_bitmap_join_prepared(carried, **kw), tau)
    assert carried.builds["bitmap"] == 0 and own.builds["bitmap"] == 2
    with pytest.raises(ValueError, match="uint32"):
        tengine.prepared_from_numpy(cj.tokens, cj.lengths, device="cpu",
                                    words={(32, "xor", False): words[(32, "xor", False)][:, :0]})


def test_prepared_collection_caches_its_artifacts():
    ct = tfrom_lists(_sets("uniform", seed=4), pad_to=_PAD)
    prep = tengine.prepare(ct, device="cpu")
    assert tengine.prepare(prep) is prep and tengine.as_prepared(prep, "cpu") is prep
    for _ in range(2):
        tjoin.blocked_bitmap_join(prep, "jaccard", 0.7, b=32, block=16, compaction="device")
    assert prep.build_counts() == {"sort": 1, "bitmap": 1, "window": 1, "prefix_index": 0,
                                   "postings": 0, "sharded_postings": 0}
    assert np.array_equal(prep.lengths, np.sort(ct.lengths, kind="stable"))
    assert np.array_equal(prep.order[prep.inverse], np.arange(ct.num_sets))
    with pytest.raises(ValueError):
        ct.tokens[0, 0] = 1  # sealed: cached artifacts derive from it


def test_device_path_never_compacts_on_host(monkeypatch):
    """Without an overflow the resident path never uses the dense route."""
    ct = tfrom_lists(_sets("uniform", seed=0), pad_to=_PAD)
    want = tjoin.blocked_bitmap_join(ct, "jaccard", 0.6, b=32, block=16, device="cpu")

    def boom(*a, **kw):
        raise AssertionError("dense host compaction used on the resident path")

    monkeypatch.setattr(tjoin, "_dense_block_verify", boom)
    got = tjoin.blocked_bitmap_join(ct, "jaccard", 0.6, b=32, block=16,
                                    compaction="device", device="cpu")
    assert np.array_equal(want, got)


def test_invalid_arguments_raise():
    ct = tfrom_lists(_sets("uniform", seed=1), pad_to=_PAD)
    with pytest.raises(ValueError, match="compaction"):
        tjoin.blocked_bitmap_join(ct, "jaccard", 0.8, compaction="gpu", device="cpu")
    prep = tengine.prepare(ct, device="cpu")
    with pytest.raises(ValueError, match="prepared on cpu"):
        tengine.prepare(prep, device="meta")
