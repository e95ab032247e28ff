"""Near-duplicate dedup: the paper's join as a first-class pipeline stage.

The port of ``repro.data.dedup``.  Documents -> shingled token sets ->
exact set-similarity self-join (Bitmap Filter accelerated) -> union-find
over similar pairs -> keep one doc per duplicate cluster.  This is the
LM-corpus deployment of the paper's technique: exact Jaccard near-dup
detection before packing/batching.

Every entry point runs its joins on the card (the port's
``blocked_bitmap_join`` and ``CorpusStore``) unless the caller passes
``device="cpu"``; a prepared corpus or a store brings its own device.

Shingles hash with Python's built-in ``hash()``, as the reference does, and
``str`` hashing is salted per process: token ids agree between two calls
only within one interpreter (or under one ``PYTHONHASHSEED``).  Shingle
both sides of a comparison in the same process.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.collection import Collection, from_lists
from repro_torch.core.constants import JACCARD
from repro_torch.core.engine import PreparedCollection, _as_store
from repro_torch.core.join import JoinStats, blocked_bitmap_join


def shingle(text: str, width: int = 5, vocab_bits: int = 30) -> List[int]:
    """Character-w-shingles hashed into a bounded token universe."""
    if len(text) < width:
        return [hash(text) % (1 << vocab_bits)]
    out = {hash(text[i:i + width]) % (1 << vocab_bits)
           for i in range(len(text) - width + 1)}
    return sorted(out)


def token_shingles(tokens: Sequence[int], width: int = 8,
                   vocab_bits: int = 30) -> List[int]:
    """w-gram shingles over a token stream (for already-tokenised corpora)."""
    t = tuple(tokens)
    if len(t) < width:
        return [hash(t) % (1 << vocab_bits)]
    out = {hash(t[i:i + width]) % (1 << vocab_bits)
           for i in range(len(t) - width + 1)}
    return sorted(out)


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, a: int) -> int:
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def _device_of(corpus, device):
    """The device a dedup call joins on: ``device`` if given, else where a
    store or a prepared corpus lives, else ``None`` (the card)."""
    if device is not None:
        return device
    store = _as_store(corpus)
    if store is not None:
        return store.device
    if isinstance(corpus, PreparedCollection):
        return corpus.device
    return None


@dataclasses.dataclass
class DedupResult:
    keep: np.ndarray          # indices of retained documents
    drop: np.ndarray          # indices removed as near-duplicates
    pairs: np.ndarray         # the similar pairs found (int64[K, 2])
    stats: JoinStats


def dedup_collection(col: Collection | PreparedCollection, tau: float = 0.8,
                     *, b: int = 128, block: int = 4096, impl: str = "auto",
                     compaction: str = "device", device=None) -> DedupResult:
    """Exact near-dup removal at Jaccard >= tau. Keeps the smallest index of
    each duplicate cluster (deterministic).

    Runs the device-resident join by default (candidate compaction and
    verification stay on the device).  Accepts a
    :class:`~repro_torch.core.engine.PreparedCollection` to reuse its cached
    length sort and bitmap words; pairs/keep/drop are always in original
    indices.
    """
    pairs, stats = blocked_bitmap_join(
        col, JACCARD, tau, b=b, block=block, impl=impl,
        compaction=compaction, return_stats=True, device=_device_of(col, device))
    uf = _UnionFind(col.num_sets)
    for i, j in pairs:
        uf.union(int(i), int(j))
    roots = np.array([uf.find(i) for i in range(col.num_sets)])
    keep_mask = roots == np.arange(col.num_sets)
    keep = np.nonzero(keep_mask)[0]
    drop = np.nonzero(~keep_mask)[0]
    return DedupResult(keep=keep, drop=drop, pairs=pairs, stats=stats)


def dedup_documents(texts: Sequence[str], tau: float = 0.8,
                    width: int = 5, **kw) -> Tuple[List[str], DedupResult]:
    col = from_lists([shingle(t, width) for t in texts])
    res = dedup_collection(col, tau, **kw)
    return [texts[i] for i in res.keep], res


# ---------------------------------------------------------------------------
# Incremental (R×S) dedup: new shard vs existing corpus
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IncrementalDedupResult:
    keep: np.ndarray             # indices of ``new`` retained
    drop_vs_corpus: np.ndarray   # indices of ``new`` similar to a corpus doc
    drop_within: np.ndarray      # indices of ``new`` dropped as internal dups
    pairs_rs: np.ndarray         # (corpus_index, new_index) similar pairs
    stats_rs: JoinStats


def dedup_against(corpus: Collection | PreparedCollection, new: Collection,
                  tau: float = 0.8, *,
                  b: int = 128, block: int = 4096, impl: str = "auto",
                  within: bool = True,
                  compaction: str = "device",
                  device=None) -> IncrementalDedupResult:
    """Dedup a new shard against an already-deduped corpus (R×S join).

    Any set in ``new`` at Jaccard >= tau to a corpus set is dropped (the
    corpus copy wins); survivors are then optionally self-deduped.  Both
    collections must live in one token space (same shingler / tokenizer run).

    When streaming many shards against one corpus, pass ``prepare(corpus)``
    once and reuse it across calls: the corpus length sort, bitmap words and
    length windows are then built a single time.

    ``corpus`` may also be a live :class:`repro_torch.store.CorpusStore`:
    the R×S join then runs the store's segment-union probe under the
    *store's* plan (``b``/``block``/``impl``/``compaction`` here only govern
    the optional within-shard pass), and ``pairs_rs`` column 0 holds
    store-global document ids, covering documents appended after the
    store's base was sealed (what closes the cross-shard leak in
    :func:`dedup_shards`).
    """
    device = _device_of(corpus, device)
    if isinstance(new, PreparedCollection):
        # Survivor sub-collections below index ``new`` by original position.
        new = new.source
    store = _as_store(corpus)
    if store is not None:
        if store.sim != JACCARD or store.tau != float(tau):
            raise ValueError(
                f"store joins at (sim={store.sim}, tau={store.tau}); "
                f"dedup_against was asked for (jaccard, {tau})")
        pairs_rs, stats_rs = store.probe(new)
    else:
        pairs_rs, stats_rs = blocked_bitmap_join(
            corpus, new, JACCARD, tau, b=b, block=block, impl=impl,
            compaction=compaction, return_stats=True, device=device)
    dup_vs_corpus = (np.unique(pairs_rs[:, 1]) if len(pairs_rs)
                     else np.zeros((0,), dtype=np.int64))
    mask = np.ones(new.num_sets, dtype=bool)
    mask[dup_vs_corpus] = False
    survivors = np.nonzero(mask)[0]
    drop_within = np.zeros((0,), dtype=np.int64)
    keep = survivors
    if within and len(survivors):
        sub = Collection(tokens=new.tokens[survivors],
                         lengths=new.lengths[survivors])
        res = dedup_collection(sub, tau, b=b, block=block, impl=impl,
                               compaction=compaction, device=device)
        keep = survivors[res.keep]
        drop_within = survivors[res.drop]
    return IncrementalDedupResult(
        keep=keep, drop_vs_corpus=dup_vs_corpus, drop_within=drop_within,
        pairs_rs=pairs_rs, stats_rs=stats_rs)


def dedup_shards(corpus: Collection | PreparedCollection,
                 shards: Sequence[Collection], tau: float = 0.8, *,
                 return_store: bool = False, policy=None,
                 **kw):
    """Stream many shards against one corpus, preparing the corpus once.

    Each shard is deduped against the *live* corpus: the original base
    **plus every prior shard's survivors**, which are sealed as
    :class:`repro_torch.store.CorpusStore` delta segments as the stream
    advances, so a duplicate pair spanning two shards keeps one copy.  The
    base corpus artifacts are built exactly once across the whole stream
    (only each small survivor delta is prepared), and the store's
    compaction ``policy`` decides when deltas fold into a new sealed base.

    Returns the per-shard results, plus the final store when
    ``return_store=True`` (hand it to ``dedup_against`` / ``JoinEngine`` /
    ``serve.JoinSession`` to keep streaming).
    """
    # Imported here: the store layers over the engine and the join.
    from repro_torch.core.plan import JoinPlan
    from repro_torch.store import CorpusStore

    plan = JoinPlan(driver="blocked", sim=JACCARD, tau=float(tau),
                    b=int(kw.get("b", 128)), block=int(kw.get("block", 4096)),
                    impl=kw.get("impl", "auto"),
                    compaction=kw.get("compaction", "device"))
    store = CorpusStore(corpus, JACCARD, float(tau), plan=plan, policy=policy,
                        device=kw.get("device"))
    results: List[IncrementalDedupResult] = []
    for shard in shards:
        res = dedup_against(store, shard, tau, **kw)
        src = shard.source if isinstance(shard, PreparedCollection) else shard
        if len(res.keep):
            store.append(Collection(tokens=src.tokens[res.keep],
                                    lengths=src.lengths[res.keep]))
        results.append(res)
    return (results, store) if return_store else results


def dedup_documents_against(corpus_texts: Sequence[str],
                            new_texts: Sequence[str], tau: float = 0.8,
                            width: int = 5,
                            **kw) -> Tuple[List[str], IncrementalDedupResult]:
    """Document flavour of :func:`dedup_against` (shared shingle space:
    both sides are shingled in this call, so hashes are comparable)."""
    corpus = from_lists([shingle(t, width) for t in corpus_texts])
    new = from_lists([shingle(t, width) for t in new_texts])
    res = dedup_against(corpus, new, tau, **kw)
    return [new_texts[i] for i in res.keep], res
