"""The port's dedup pipeline (``repro_torch.data.dedup``) against the JAX
package's, on the CPU, in one process.

Shingles hash with Python's salted ``hash()`` in both packages, so token ids
agree only within one interpreter: every parity test here shingles both
sides in this process.  Every entry point gives the reference's keep, drop,
pairs and ``JoinStats``, exactly; ``dedup_against`` from a plain, a prepared
and a store corpus.  Then the port's twins of the reference's
post-condition tests (the store's leak-free streaming dedup, one corpus
preparation across shards, planted clusters collapsing, incremental dedup),
and ``dblp_like_collection``'s arrays.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core.collection import from_lists as jfrom_lists
from repro.core.plan import JoinPlan as JJoinPlan
from repro.data import collections as jcollections
from repro.data import dedup as jdedup
from repro.store import CorpusStore as JCorpusStore
from repro_torch.core import engine as tengine
from repro_torch.core import join as tjoin
from repro_torch.core.collection import Collection as TCollection
from repro_torch.core.collection import from_lists as tfrom_lists
from repro_torch.core.plan import JoinPlan as TJoinPlan
from repro_torch.data import collections as tcollections
from repro_torch.data import dedup as tdedup
from repro_torch.store import CorpusStore as TCorpusStore

_PAD = 12
KW = dict(b=32, block=16)


def _lists(n, seed, kind="uniform", universe=90):
    rng = np.random.default_rng(seed)
    if kind == "dup_heavy":
        base = [rng.choice(universe, size=rng.integers(2, 11), replace=False).tolist()
                for _ in range(max(n // 3, 1))]
        sets = []
        for _ in range(n):
            src = base[int(rng.integers(len(base)))]
            kept = [t for t in src if rng.random() > 0.15]
            sets.append(kept or src[:1])
        return sets
    return [rng.choice(universe, size=rng.integers(1, 11), replace=False).tolist()
            for _ in range(n)]


def _both(sets):
    return jfrom_lists(sets, pad_to=_PAD), tfrom_lists(sets, pad_to=_PAD)


def _same_result(got, want, what=""):
    """Two dedup results (either dataclass) hold identical arrays and stats."""
    assert type(got).__name__ == type(want).__name__
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), (what, field.name)
        else:
            assert a.to_dict() == b.to_dict(), (what, field.name)


def _docs(n, seed):
    """``n`` seeded documents: a third exact copies of earlier ones, a third
    with one character changed, the rest fresh."""
    rng = np.random.default_rng(seed)
    words = [f"w{k}" for k in range(300)]
    docs = []
    for i in range(n):
        kind = i % 3 if i >= 3 else 2
        if kind == 0:
            docs.append(docs[int(rng.integers(len(docs)))])
        elif kind == 1:
            src = docs[int(rng.integers(len(docs)))]
            k = int(rng.integers(len(src)))
            docs.append(src[:k] + "#" + src[k + 1:])
        else:
            docs.append(" ".join(rng.choice(words, size=int(rng.integers(8, 30)))))
    return docs


@pytest.mark.parametrize("compaction", ["host", "device"])
@pytest.mark.parametrize("tau", [0.5, 0.8, 0.95])
def test_dedup_collection_matches_reference(tau, compaction):
    base = jcollections.uniform_collection(n_sets=150, avg_size=10, n_tokens=250, seed=7)
    jcol = jcollections.with_duplicates(base, n_clusters=12, cluster_size=3, jaccard=0.9,
                                        seed=8)
    tcol = tcollections.with_duplicates(
        tcollections.uniform_collection(n_sets=150, avg_size=10, n_tokens=250, seed=7),
        n_clusters=12, cluster_size=3, jaccard=0.9, seed=8)
    assert np.array_equal(jcol.tokens, tcol.tokens)
    kw = dict(KW, compaction=compaction)
    want = jdedup.dedup_collection(jcol, tau, **kw)
    _same_result(tdedup.dedup_collection(tcol, tau, **kw, device="cpu"), want, "plain")
    prep = tengine.prepare(tcol, "cpu")
    _same_result(tdedup.dedup_collection(prep, tau, **kw), want, "prepared")
    assert len(want.drop) > 0


@pytest.mark.parametrize("width", [3, 5])
def test_dedup_documents_matches_reference(width):
    docs = _docs(120, width) + ["ab", ""]
    assert all(tdedup.shingle(d, width) == jdedup.shingle(d, width) for d in docs)
    tokens = [list(np.random.default_rng(i).integers(0, 50, size=i % 20)) for i in range(30)]
    assert all(tdedup.token_shingles(t, 4) == jdedup.token_shingles(t, 4) for t in tokens)
    want_kept, want = jdedup.dedup_documents(docs, 0.8, width, **KW)
    got_kept, got = tdedup.dedup_documents(docs, 0.8, width, **KW, device="cpu")
    assert got_kept == want_kept and len(got_kept) < len(docs)
    _same_result(got, want)
    new = _docs(60, 9)[20:] + docs[:10]
    want_kept, want = jdedup.dedup_documents_against(docs, new, 0.7, width, **KW)
    got_kept, got = tdedup.dedup_documents_against(docs, new, 0.7, width, **KW,
                                                    device="cpu")
    assert got_kept == want_kept and len(want.drop_vs_corpus) >= 10
    _same_result(got, want)


@pytest.mark.parametrize("within", [True, False])
@pytest.mark.parametrize("corpus_kind", ["plain", "prepared", "store", "store_with_delta"])
def test_dedup_against_matches_reference(corpus_kind, within):
    jcorpus, tcorpus = _both(_lists(40, 3, "dup_heavy"))
    new_lists = _lists(30, 4, "dup_heavy")
    new_lists[:5] = [list(tcorpus.row(k)) for k in range(5)]
    jnew, tnew = _both(new_lists)
    kw = dict(KW, within=within, compaction="host")
    if corpus_kind == "plain":
        jc, tc = jcorpus, tcorpus
    elif corpus_kind == "prepared":   # a prepared corpus brings its device
        jc, tc = jengine.prepare(jcorpus), tengine.prepare(tcorpus, "cpu")
    else:
        plan = dict(driver="blocked", sim="jaccard", tau=0.7, b=32, block=16)
        jc = JCorpusStore(jcorpus, "jaccard", 0.7, plan=JJoinPlan(**plan))
        tc = TCorpusStore(tcorpus, "jaccard", 0.7, plan=TJoinPlan(**plan), device="cpu")
        if corpus_kind == "store_with_delta":
            jd, td = _both(_lists(12, 5, "dup_heavy"))
            jc.append(jd)
            tc.append(td)
    kw_port = dict(kw, device="cpu") if corpus_kind == "plain" else kw
    want = jdedup.dedup_against(jc, jnew, 0.7, **kw)
    got = tdedup.dedup_against(tc, tnew, 0.7, **kw_port)
    _same_result(got, want, corpus_kind)
    assert len(want.drop_vs_corpus) >= 5
    if corpus_kind.startswith("store"):
        with pytest.raises(ValueError, match="store joins at"):
            tdedup.dedup_against(tc, tnew, 0.8)


@pytest.mark.parametrize("prepared", [False, True])
def test_dedup_shards_matches_reference(prepared):
    sets = _lists(60, 11, "dup_heavy")
    jcorpus, tcorpus = _both(sets[:20])
    shards = [_both(sets[a:a + 10]) for a in range(20, 60, 10)]
    if prepared:
        jcorpus, tcorpus = jengine.prepare(jcorpus), tengine.prepare(tcorpus, "cpu")
    kw = dict(KW, compaction="host")
    want, jstore = jdedup.dedup_shards(jcorpus, [j for j, _ in shards], 0.7,
                                       return_store=True, **kw)
    got, tstore = tdedup.dedup_shards(tcorpus, [t for _, t in shards], 0.7,
                                      return_store=True, device="cpu", **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _same_result(g, w)
    assert np.array_equal(tstore.collection().tokens, jstore.collection().tokens)
    assert tstore.builds() == {k: v for k, v in jstore.builds().items() if k in tstore.builds()}
    assert tstore.device.type == "cpu" and tstore.plan.to_dict() == jstore.plan.to_dict()
    assert tdedup.dedup_shards(tcorpus, [], 0.7, device="cpu", **kw) == []


def test_dblp_like_collection_matches_reference():
    for n, seed in ((50, 0), (300, 4)):
        want = jcollections.dblp_like_collection(n, seed)
        got = tcollections.dblp_like_collection(n, seed)
        for a, b in ((got.tokens, want.tokens), (got.lengths, want.lengths)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Twins of the reference's post-condition tests, on the port alone
# ---------------------------------------------------------------------------

def test_dedup_shards_cross_shard_leak_regression():
    """A duplicate pair spanning shard 1 and shard 2 (absent from the
    corpus) keeps one copy: shard 2 sees shard 1's survivors through the
    store (twin of ``tests/test_store.py``)."""
    corpus = tfrom_lists([[1, 2, 3, 4, 5], [10, 11, 12, 13], [20, 21, 22, 23, 24]],
                         pad_to=_PAD)
    dup = [40, 41, 42, 43, 44]
    s1 = tfrom_lists([dup, [50, 51, 52]], pad_to=_PAD)
    s2 = tfrom_lists([dup, [60, 61, 62, 63]], pad_to=_PAD)
    res, store = tdedup.dedup_shards(corpus, [s1, s2], 0.8, **KW, compaction="host",
                                     return_store=True, device="cpu")
    assert list(res[0].keep) == [0, 1]
    assert list(res[1].keep) == [1]
    assert 0 in res[1].drop_vs_corpus
    assert store.num_sets == 3 + 2 + 1
    # Corpus-only dedup keeps both copies.
    assert list(tdedup.dedup_against(corpus, s2, 0.8, **KW, compaction="host",
                                     device="cpu").keep) == [0, 1]


def test_dedup_shards_survivor_set_is_pairwise_dissimilar():
    """Starting from a deduped base, the final store's self-join is empty,
    and some document was dropped against a prior shard's survivor (twin of
    ``tests/test_store.py``)."""
    big = tfrom_lists(_lists(44, 7, "dup_heavy"), pad_to=_PAD)

    def rows(a, b):
        return TCollection(tokens=big.tokens[a:b].copy(), lengths=big.lengths[a:b].copy())

    raw = rows(0, 14)
    base = tdedup.dedup_collection(raw, 0.7, **KW, compaction="host", device="cpu")
    corpus = TCollection(tokens=raw.tokens[base.keep], lengths=raw.lengths[base.keep])
    shards = [rows(14, 24), rows(24, 34), rows(34, 44)]
    res, store = tdedup.dedup_shards(corpus, shards, 0.7, **KW, compaction="host",
                                     return_store=True, device="cpu")
    assert len(store.self_join()) == 0
    assert any(len(r.pairs_rs) and r.pairs_rs[:, 0].max() >= corpus.num_sets for r in res)


def test_dedup_against_prepared_corpus_matches_plain():
    corpus, shard = _both(_lists(50, 16))[1], _both(_lists(30, 17))[1]
    shard = tfrom_lists([list(corpus.row(k)) for k in range(6)]
                        + shard.as_lists()[6:], pad_to=_PAD)
    plain = tdedup.dedup_against(corpus, shard, 0.8, b=32, block=16, compaction="host",
                                 device="cpu")
    got = tdedup.dedup_against(tengine.prepare(corpus, "cpu"), shard, 0.8, b=32, block=16,
                               compaction="host")
    assert np.array_equal(plain.keep, got.keep)
    assert np.array_equal(plain.pairs_rs, got.pairs_rs)
    assert len(plain.drop_vs_corpus) >= 6


def test_dedup_shards_prepares_corpus_once():
    corpus = tfrom_lists(_lists(50, 17), pad_to=_PAD)
    s1 = tfrom_lists(_lists(20, 18), pad_to=_PAD)
    s2 = tfrom_lists(_lists(20, 19), pad_to=_PAD)
    prep = tengine.prepare(corpus, "cpu")
    results = tdedup.dedup_shards(prep, [s1, s2], 0.8, b=32, block=16,
                                  compaction="host", within=False)
    assert len(results) == 2
    assert prep.builds["sort"] == 1 and prep.builds["bitmap"] == 1
    for res, shard in zip(results, (s1, s2)):
        ref = tdedup.dedup_against(corpus, shard, 0.8, b=32, block=16,
                                   compaction="host", within=False, device="cpu")
        assert np.array_equal(res.keep, ref.keep)


def test_dedup_collapses_planted_clusters():
    base = tcollections.uniform_collection(n_sets=120, avg_size=12, n_tokens=400, seed=5)
    col = tcollections.with_duplicates(base, n_clusters=8, cluster_size=3, jaccard=0.92,
                                       seed=6)
    res = tdedup.dedup_collection(col, tau=0.8, b=64, block=64, device="cpu")
    assert len(res.pairs) >= 8
    assert len(res.drop) >= 8
    assert len(res.keep) + len(res.drop) == col.num_sets
    kept = TCollection(tokens=col.tokens[res.keep], lengths=col.lengths[res.keep])
    assert len(tdedup.dedup_collection(kept, tau=0.8, b=64, block=64, device="cpu").drop) == 0
    assert np.array_equal(res.pairs, tjoin.naive_join(col, "jaccard", 0.8, device="cpu"))


def test_incremental_dedup_against_corpus():
    rng = np.random.default_rng(9)
    sets_r = [rng.choice(90, size=rng.integers(1, 14), replace=False).tolist()
              for _ in range(60)]
    sets_s = [rng.choice(90, size=rng.integers(1, 14), replace=False).tolist()
              for _ in range(45)]
    for k in range(5):
        sets_s[k] = sets_r[2 * k]
    from repro_torch.core.collection import preprocess_rs

    col_r, col_s = preprocess_rs(tfrom_lists(sets_r), tfrom_lists(sets_s))
    res = tdedup.dedup_against(col_r, col_s, tau=0.95, b=64, block=32, device="cpu")
    assert len(res.drop_vs_corpus) >= 5
    assert 0.0 <= res.stats_rs.filter_ratio <= 1.0
    assert (np.sort(np.concatenate([res.keep, res.drop_vs_corpus, res.drop_within]))
            == np.arange(col_s.num_sets)).all()
