"""Faithful reproductions of the four CPU algorithms the paper accelerates.

AllPairs [3], PPJoin [25], GroupJoin [4] and AdaptJoin [23], each with a
pluggable Bitmap Filter exactly where Section 4.1 inserts it:

* AllPairs / PPJoin / GroupJoin: bitmap test in the **verification loop**
  (``filter_3`` — once per unique candidate; for GroupJoin after group
  expansion);
* AdaptJoin: bitmap test at **candidate generation** (``filter_2``) during the
  1-prefix iteration.

The port of ``repro.core.cpu_algos``, line for line: numpy/python
implementations (the originals are C++), so absolute runtimes are not
comparable to the paper's Table 5, but the *relative* improvement of +BF vs
the original, the paper's actual claim, is (``chip_smoke.py`` phase 13
times it).  All four return exactly the oracle pair set and the reference's
``AlgoStats`` (tested).  Only the bitmap words of a filter are built on a
device (:class:`~repro_torch.core.filters.BitmapFilter`).

Every algorithm supports both the self-join (``algo(col, sim, tau)``) and the
paper's general two-collection R×S join (``algo(col_r, col_s, sim, tau)``):
the prefix index is built over R and probed with S, and the bitmap filter
(built with :meth:`BitmapFilter.build_rs` for R×S) runs at the same
``filter_2``/``filter_3`` points.

Self-join inputs must be preprocessed with
:func:`repro_torch.core.collection.preprocess`, R×S inputs with
:func:`repro_torch.core.collection.preprocess_rs` (a *shared* token-frequency
ordering across both collections — prefix-filter correctness needs a common
total order) — both the prefix filter's selectivity and the sorted-index
length early-out rely on it.

All four algorithms also accept
:class:`~repro_torch.core.engine.PreparedCollection` inputs: the algorithm bodies
run over the prepared (length-sorted) view, the ℓ-prefix inverted index comes
from the prepared cache (built once per ``(sim, tau, ell)``), and the
returned pairs are remapped to original collection indices.  A ``bitmap=``
filter passed alongside prepared inputs must be built over the prepared
order — use :func:`repro_torch.core.engine.prepared_bitmap_filter`.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import bounds, verify
from repro_torch.core.collection import Collection, split_join_args
from repro_torch.core.constants import JACCARD
from repro_torch.core.engine import PreparedCollection
from repro_torch.core.filters import BitmapFilter


@dataclasses.dataclass
class AlgoStats:
    candidates: int = 0           # pairs reaching the verification stage
    bitmap_pruned: int = 0        # pairs pruned by the Bitmap Filter
    verified: int = 0             # exact verifications executed
    results: int = 0


def _build_prefix_index(col: Collection, sim: str, tau: float,
                        ell: int = 1) -> Dict[int, List[Tuple[int, int]]]:
    """Inverted index over ℓ-prefixes: token -> [(set_id, position)].

    Lists are naturally sorted by set id == by length (collection is
    size-sorted), which the length filter's early-outs exploit.  A
    :class:`~repro_torch.core.engine.PreparedCollection` answers from its cache
    (built at most once per ``(sim, tau, ell)``).
    """
    if isinstance(col, PreparedCollection):
        return col.prefix_index(sim, tau, ell)
    index: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for i in range(col.num_sets):
        n = int(col.lengths[i])
        p = _prefix_len(sim, tau, n, ell)
        for pos in range(p):
            index[int(col.tokens[i, pos])].append((i, pos))
    return index



@functools.lru_cache(maxsize=None)
def _int_window(sim: str, tau: float, n: int) -> Tuple[int, int]:
    """Scalar integer length window (single source of truth:
    :func:`repro_torch.core.bounds.length_window_int` — the raw float bounds can
    exclude boundary partners that exact verification accepts).  Cached:
    the drift-corrected window costs ~10 numpy temporaries per call and
    sits in every probe loop; (sim, tau, n) keys repeat heavily."""
    lo, hi = bounds.length_window_int(sim, tau, n)
    return int(lo), int(hi)


@functools.lru_cache(maxsize=None)
def _prefix_len(sim: str, tau: float, n: int, ell: int = 1) -> int:
    """Cached scalar ℓ-prefix length (same caching rationale as
    :func:`_int_window`; :func:`repro_torch.core.bounds.prefix_length` now routes
    through the corrected window and is no longer a two-flop closed form)."""
    return int(bounds.prefix_length_ell(sim, tau, n, ell))


@functools.lru_cache(maxsize=None)
def _min_overlap(sim: str, tau: float, lr: int, ls: int) -> int:
    """Cached scalar minimal oracle-accepted overlap (integer-exact
    acceptance, identical to ``o >= equivalent_overlap`` for integer o)."""
    return int(bounds.min_overlap_int(sim, tau, lr, ls))

def _verify_pair(col: Collection, r: int, s: int, sim: str, tau: float,
                 stats: AlgoStats) -> bool:
    stats.verified += 1
    need = _min_overlap(sim, tau, int(col.lengths[r]), int(col.lengths[s]))
    o = verify.overlap_early_terminate(col.row(r), col.row(s), need)
    return o >= need


def _verify_pair_rs(col_r: Collection, col_s: Collection, r: int, s: int,
                    sim: str, tau: float, stats: AlgoStats) -> bool:
    stats.verified += 1
    need = _min_overlap(sim, tau, int(col_r.lengths[r]), int(col_s.lengths[s]))
    o = verify.overlap_early_terminate(col_r.row(r), col_s.row(s), need)
    return o >= need


def _pack_pairs_rs(results: List[Tuple[int, int]]) -> np.ndarray:
    """(r_index, s_index) pairs — no i<j canonicalisation across collections."""
    if not results:
        return np.zeros((0, 2), dtype=np.int64)
    return np.asarray(sorted(set(results)), dtype=np.int64)


def _prepared_remapper(col, col_s):
    """Map result pairs from prepared (length-sorted) space back to original
    collection indices.

    The algorithm bodies run unchanged over a
    :class:`~repro_torch.core.engine.PreparedCollection` (it duck-types the read
    surface of ``Collection`` over its sorted view), so their pair indices
    come out in sorted space; this remaps them through ``order`` and restores
    the canonical ordering (i < j for self-joins, lexicographic sort).  With
    plain ``Collection`` inputs it is the identity.

    NOTE: a ``bitmap=`` filter passed alongside prepared inputs must be built
    over the *prepared* order (see
    :func:`repro_torch.core.engine.prepared_bitmap_filter`) — index spaces must
    agree or pruning is incorrect.
    """
    order_r = col.order if isinstance(col, PreparedCollection) else None
    self_join = col_s is None
    order_s = (order_r if self_join
               else col_s.order if isinstance(col_s, PreparedCollection)
               else None)
    if order_r is None and order_s is None:
        return lambda pairs: pairs

    def remap(pairs: np.ndarray) -> np.ndarray:
        if len(pairs) == 0:
            return pairs
        gi = order_r[pairs[:, 0]] if order_r is not None else pairs[:, 0]
        gj = order_s[pairs[:, 1]] if order_s is not None else pairs[:, 1]
        if self_join:
            out = np.stack([np.minimum(gi, gj), np.maximum(gi, gj)], axis=1)
        else:
            out = np.stack([gi, gj], axis=1)
        return out[np.lexsort((out[:, 1], out[:, 0]))].astype(np.int64)

    return remap


# ---------------------------------------------------------------------------
# AllPairs [3]: prefix filter (filter_1) + length filter (filter_2)
# ---------------------------------------------------------------------------

def _rs_probe_candidates(index, col_r: Collection, col_s: Collection, s: int,
                         sim: str, tau: float, positional: bool) -> set:
    """Candidate R ids for probe set ``s`` (shared prefix token + length
    window; optional positional filter at the first match)."""
    ls = int(col_s.lengths[s])
    p = _prefix_len(sim, tau, ls)
    lo, hi = _int_window(sim, tau, ls)
    seen: set[int] = set()
    for pos in range(p):
        for r, rpos in index[int(col_s.tokens[s, pos])]:
            lr = int(col_r.lengths[r])
            if lr > hi:
                break  # index lists are length-sorted: later r only longer
            if lr < lo:
                continue
            if r in seen:
                continue
            if positional:
                ub = bounds.positional_upper_bound(lr, ls, rpos, pos)
                need = bounds.equivalent_overlap(sim, tau, lr, ls)
                if ub < need:
                    continue
            seen.add(r)
    return seen


def _allpairs_like_rs(col_r: Collection, col_s: Collection, sim: str,
                      tau: float, bitmap: Optional[BitmapFilter],
                      stats: AlgoStats, positional: bool) -> np.ndarray:
    """Shared R×S driver for AllPairs (positional=False) / PPJoin (True)."""
    index = _build_prefix_index(col_r, sim, tau)
    results: List[Tuple[int, int]] = []
    for s in range(col_s.num_sets):
        seen = _rs_probe_candidates(index, col_r, col_s, s, sim, tau, positional)
        cands = np.fromiter(seen, dtype=np.int64, count=len(seen))
        stats.candidates += len(cands)
        if bitmap is not None and len(cands):
            pruned = bitmap.prune_mask(s, cands)  # filter_3 (probe side = S)
            stats.bitmap_pruned += int(pruned.sum())
            cands = cands[~pruned]
        for r in cands:
            if _verify_pair_rs(col_r, col_s, int(r), s, sim, tau, stats):
                results.append((int(r), s))
    stats.results = len(results)
    return _pack_pairs_rs(results)


def allpairs(col: Collection, col_s=None, sim: str = JACCARD, tau: float = 0.8,
             bitmap: Optional[BitmapFilter] = None,
             stats: Optional[AlgoStats] = None) -> np.ndarray:
    col_s, sim, tau = split_join_args(col_s, sim, tau)
    stats = stats if stats is not None else AlgoStats()
    remap = _prepared_remapper(col, col_s)
    if col_s is not None:
        return remap(_allpairs_like_rs(col, col_s, sim, tau, bitmap, stats,
                                       positional=False))
    index = _build_prefix_index(col, sim, tau)
    lengths = col.lengths
    results: List[Tuple[int, int]] = []
    for r in range(col.num_sets):
        lr = int(lengths[r])
        p = _prefix_len(sim, tau, lr)
        lo, _ = _int_window(sim, tau, lr)
        seen: set[int] = set()
        for pos in range(p):
            for s, _spos in index[int(col.tokens[r, pos])]:
                if s >= r:
                    break  # index lists are id-sorted; only s < r probes r's index
                if lengths[s] < lo:  # length filter (lists sorted by length)
                    continue
                seen.add(s)
        cands = np.fromiter(seen, dtype=np.int64, count=len(seen))
        stats.candidates += len(cands)
        if bitmap is not None and len(cands):
            pruned = bitmap.prune_mask(r, cands)  # filter_3
            stats.bitmap_pruned += int(pruned.sum())
            cands = cands[~pruned]
        for s in cands:
            if _verify_pair(col, r, int(s), sim, tau, stats):
                results.append((int(s), r))
    stats.results = len(results)
    return remap(_pack_pairs(results))


# ---------------------------------------------------------------------------
# PPJoin [25]: AllPairs + positional filter in candidate generation
# ---------------------------------------------------------------------------

def ppjoin(col: Collection, col_s=None, sim: str = JACCARD, tau: float = 0.8,
           bitmap: Optional[BitmapFilter] = None,
           stats: Optional[AlgoStats] = None) -> np.ndarray:
    col_s, sim, tau = split_join_args(col_s, sim, tau)
    stats = stats if stats is not None else AlgoStats()
    remap = _prepared_remapper(col, col_s)
    if col_s is not None:
        return remap(_allpairs_like_rs(col, col_s, sim, tau, bitmap, stats,
                                       positional=True))
    index = _build_prefix_index(col, sim, tau)
    lengths = col.lengths
    results: List[Tuple[int, int]] = []
    for r in range(col.num_sets):
        lr = int(lengths[r])
        p = _prefix_len(sim, tau, lr)
        lo, _ = _int_window(sim, tau, lr)
        seen: set[int] = set()
        for pos in range(p):
            for s, spos in index[int(col.tokens[r, pos])]:
                if s >= r:
                    break
                ls = int(lengths[s])
                if ls < lo:
                    continue
                if s in seen:
                    continue
                # Positional filter (filter_2): bound from first match position.
                ub = bounds.positional_upper_bound(lr, ls, pos, spos)
                need = bounds.equivalent_overlap(sim, tau, lr, ls)
                if ub < need:
                    continue
                seen.add(s)
        cands = np.fromiter(seen, dtype=np.int64, count=len(seen))
        stats.candidates += len(cands)
        if bitmap is not None and len(cands):
            pruned = bitmap.prune_mask(r, cands)  # filter_3
            stats.bitmap_pruned += int(pruned.sum())
            cands = cands[~pruned]
        for s in cands:
            if _verify_pair(col, r, int(s), sim, tau, stats):
                results.append((int(s), r))
    stats.results = len(results)
    return remap(_pack_pairs(results))


# ---------------------------------------------------------------------------
# GroupJoin [4]: PPJoin filters over groups of identical (size, prefix)
# ---------------------------------------------------------------------------

def _group_by_size_prefix(col: Collection, sim: str, tau: float):
    """Group sets sharing (size, prefix tokens); returns (members, reps)."""
    group_of: Dict[Tuple, int] = {}
    members: List[List[int]] = []
    rep: List[int] = []
    for i in range(col.num_sets):
        n = int(col.lengths[i])
        p = _prefix_len(sim, tau, n)
        key = (n, tuple(int(t) for t in col.tokens[i, :p]))
        g = group_of.get(key)
        if g is None:
            group_of[key] = len(members)
            members.append([i])
            rep.append(i)
        else:
            members[g].append(i)
    return members, rep


def _groupjoin_rs(col_r: Collection, col_s: Collection, sim: str, tau: float,
                  bitmap: Optional[BitmapFilter], stats: AlgoStats) -> np.ndarray:
    """R×S GroupJoin: R grouped by (size, prefix), probed with each S set.

    Filters run once per (probe, R-group); the bitmap filter applies to the
    *expanded* member pairs (paper Section 4.1).  No within-group stage — those
    pairs are R–R, which a two-collection join never reports.
    """
    members, rep = _group_by_size_prefix(col_r, sim, tau)
    grows = [col_r.row(rep[g]) for g in range(len(members))]
    glen = np.array([len(r) for r in grows], dtype=np.int64)

    index: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for g, row in enumerate(grows):
        p = _prefix_len(sim, tau, len(row))
        for pos in range(p):
            index[int(row[pos])].append((g, pos))

    results: List[Tuple[int, int]] = []
    for s in range(col_s.num_sets):
        ls = int(col_s.lengths[s])
        p = _prefix_len(sim, tau, ls)
        lo, hi = _int_window(sim, tau, ls)
        seen: set[int] = set()
        for pos in range(p):
            for g, gpos in index[int(col_s.tokens[s, pos])]:
                lg = int(glen[g])
                if lg > hi:
                    break  # groups are length-sorted like their members
                if lg < lo or g in seen:
                    continue
                ub = bounds.positional_upper_bound(lg, ls, gpos, pos)
                need = bounds.equivalent_overlap(sim, tau, lg, ls)
                if ub < need:
                    continue
                seen.add(g)
        for g in seen:
            cands = np.asarray(members[g], dtype=np.int64)
            stats.candidates += len(cands)
            if bitmap is not None:
                pruned = bitmap.prune_mask(s, cands)
                stats.bitmap_pruned += int(pruned.sum())
                cands = cands[~pruned]
            for r in cands:
                if _verify_pair_rs(col_r, col_s, int(r), s, sim, tau, stats):
                    results.append((int(r), s))
    stats.results = len(results)
    return _pack_pairs_rs(results)


def groupjoin(col: Collection, col_s=None, sim: str = JACCARD, tau: float = 0.8,
              bitmap: Optional[BitmapFilter] = None,
              stats: Optional[AlgoStats] = None) -> np.ndarray:
    col_s, sim, tau = split_join_args(col_s, sim, tau)
    stats = stats if stats is not None else AlgoStats()
    remap = _prepared_remapper(col, col_s)
    if col_s is not None:
        return remap(_groupjoin_rs(col, col_s, sim, tau, bitmap, stats))
    # Group sets sharing (size, prefix tokens). Filters run once per group
    # representative; the verification stage expands groups to members.
    members, rep = _group_by_size_prefix(col, sim, tau)
    gcol_rows = [col.row(rep[g]) for g in range(len(members))]
    glen = np.array([len(r) for r in gcol_rows], dtype=np.int64)

    index: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for g, row in enumerate(gcol_rows):
        p = _prefix_len(sim, tau, len(row))
        for pos in range(p):
            index[int(row[pos])].append((g, pos))

    results: List[Tuple[int, int]] = []
    for g, row in enumerate(gcol_rows):
        lg = int(glen[g])
        p = _prefix_len(sim, tau, lg)
        lo, _ = _int_window(sim, tau, lg)
        seen: set[int] = set()
        for pos in range(p):
            for h, hpos in index[int(row[pos])]:
                if h >= g:
                    break
                lh = int(glen[h])
                if lh < lo:
                    continue
                if h in seen:
                    continue
                ub = bounds.positional_upper_bound(lg, lh, pos, hpos)
                need = bounds.equivalent_overlap(sim, tau, lg, lh)
                if ub < need:
                    continue
                seen.add(h)
        # Expand groups: candidate pairs are member cross-products; the
        # bitmap filter (filter_3) applies to *individual* expanded pairs
        # (paper Section 4.1). Batched per left member.
        for h in seen:
            partner = np.asarray(members[h], dtype=np.int64)
            for r in members[g]:
                stats.candidates += len(partner)
                cands = partner
                if bitmap is not None:
                    pruned = bitmap.prune_mask(r, cands)
                    stats.bitmap_pruned += int(pruned.sum())
                    cands = cands[~pruned]
                for s in cands:
                    if _verify_pair(col, r, int(s), sim, tau, stats):
                        results.append(_ordered(r, int(s)))
        # Within-group pairs: identical prefixes and sizes — still must verify.
        gm = members[g]
        for a in range(len(gm)):
            partner = np.asarray(gm[a + 1:], dtype=np.int64)
            if len(partner) == 0:
                continue
            stats.candidates += len(partner)
            cands = partner
            if bitmap is not None:
                pruned = bitmap.prune_mask(gm[a], cands)
                stats.bitmap_pruned += int(pruned.sum())
                cands = cands[~pruned]
            for s in cands:
                if _verify_pair(col, gm[a], int(s), sim, tau, stats):
                    results.append(_ordered(gm[a], int(s)))
    stats.results = len(results)
    return remap(_pack_pairs(results))


# ---------------------------------------------------------------------------
# AdaptJoin [23]: variable-length prefix schema
# ---------------------------------------------------------------------------

def _adapt_select_ell(match_count: Dict[int, int], probe_cost: int,
                      max_ell: int, sim: str, tau: float, n: int):
    """Adaptive ℓ selection: take the smallest ℓ whose candidate count stops
    paying for another index pass (monotone counts make this the standard
    [23] heuristic).  Returns (ell, candidate ids at that level).

    The ℓ-prefix theorem guarantees ≥ ℓ shared prefix tokens only when the
    required overlap itself is ≥ ℓ, so ℓ is capped at the probe's minimum
    equivalent overlap (= n - prefix_length(n) + 1) — without the cap, small
    sets with o_req < ℓ lose true pairs.
    """
    o_min = max(n - _prefix_len(sim, tau, n) + 1, 1)
    max_ell = min(max_ell, o_min)
    cand_at = []
    for l in range(1, max_ell + 1):
        cand_at.append([s for s, c in match_count.items() if c >= l])
    ell = 1
    for l in range(1, max_ell):
        saving = len(cand_at[l - 1]) - len(cand_at[l])
        if saving > probe_cost:
            ell = l + 1
        else:
            break
    return ell, cand_at[ell - 1]


def _adaptjoin_rs(col_r: Collection, col_s: Collection, sim: str, tau: float,
                  bitmap: Optional[BitmapFilter], stats: AlgoStats,
                  max_ell: int) -> np.ndarray:
    """R×S AdaptJoin: the ℓ-prefix index over R, probed with every S set."""
    index = _build_prefix_index(col_r, sim, tau, ell=max_ell)
    results: List[Tuple[int, int]] = []
    for s in range(col_s.num_sets):
        ls = int(col_s.lengths[s])
        lo, hi = _int_window(sim, tau, ls)
        match_count: Dict[int, int] = defaultdict(int)
        plen = _prefix_len(sim, tau, ls, max_ell)
        for pos in range(plen):
            for r, _rpos in index[int(col_s.tokens[s, pos])]:
                lr = int(col_r.lengths[r])
                if lr > hi:
                    break  # length-sorted index lists
                if lr < lo:
                    continue
                match_count[r] += 1
        ell, cand_ids = _adapt_select_ell(match_count, ls, max_ell, sim, tau, ls)
        cands = np.asarray(sorted(cand_ids), dtype=np.int64)
        stats.candidates += len(cands)
        if bitmap is not None and len(cands) and ell == 1:
            pruned = bitmap.prune_mask(s, cands)  # filter_2 @ 1-prefix pass
            stats.bitmap_pruned += int(pruned.sum())
            cands = cands[~pruned]
        for r in cands:
            if _verify_pair_rs(col_r, col_s, int(r), s, sim, tau, stats):
                results.append((int(r), s))
    stats.results = len(results)
    return _pack_pairs_rs(results)


def adaptjoin(col: Collection, col_s=None, sim: str = JACCARD, tau: float = 0.8,
              bitmap: Optional[BitmapFilter] = None,
              stats: Optional[AlgoStats] = None,
              max_ell: int = 3) -> np.ndarray:
    """AdaptJoin with the ℓ-prefix schema and a candidate-count cost model.

    For each probe the algorithm extends the prefix (ℓ = 1, 2, ...) while the
    estimated saving (candidates dropped x verify cost) exceeds the extra
    index-probe cost — the simplified cost model of [23].  Candidates must
    share >= ℓ prefix tokens.  The Bitmap Filter runs at candidate generation
    (filter_2) during the ℓ=1 iteration, per paper Section 4.1.

    R×S form: the ℓ-prefix index is built over R and probed with every S set.
    """
    col_s, sim, tau = split_join_args(col_s, sim, tau)
    stats = stats if stats is not None else AlgoStats()
    remap = _prepared_remapper(col, col_s)
    if col_s is not None:
        return remap(_adaptjoin_rs(col, col_s, sim, tau, bitmap, stats, max_ell))
    index = _build_prefix_index(col, sim, tau, ell=max_ell)
    lengths = col.lengths
    results: List[Tuple[int, int]] = []
    for r in range(col.num_sets):
        lr = int(lengths[r])
        lo, _ = _int_window(sim, tau, lr)
        # Count prefix-token matches per probed set for each ℓ level.
        match_count: Dict[int, int] = defaultdict(int)
        plen = [_prefix_len(sim, tau, lr, l) for l in range(1, max_ell + 1)]
        # Probe the widest prefix once; candidates at level ℓ are those with
        # match_count >= ℓ inside the level's prefix window.
        for pos in range(plen[-1]):
            for s, spos in index[int(col.tokens[r, pos])]:
                if s >= r:
                    break
                ls = int(lengths[s])
                if ls < lo:
                    continue
                # s's own prefix at level ℓ shrinks too; the index stores
                # max_ell prefixes, so re-check the position lazily below.
                match_count[s] += 1
        ell, cand_ids = _adapt_select_ell(match_count, lr, max_ell, sim, tau, lr)
        cands = np.asarray(sorted(cand_ids), dtype=np.int64)
        stats.candidates += len(cands)
        if bitmap is not None and len(cands) and ell == 1:
            pruned = bitmap.prune_mask(r, cands)  # filter_2 @ 1-prefix pass
            stats.bitmap_pruned += int(pruned.sum())
            cands = cands[~pruned]
        for s in cands:
            if _verify_pair(col, r, int(s), sim, tau, stats):
                results.append((int(s), r))
    stats.results = len(results)
    return remap(_pack_pairs(results))


ALGORITHMS: Dict[str, Callable] = {
    "allpairs": allpairs,
    "ppjoin": ppjoin,
    "groupjoin": groupjoin,
    "adaptjoin": adaptjoin,
}


def _ordered(r: int, s: int) -> Tuple[int, int]:
    return (s, r) if s < r else (r, s)


def _pack_pairs(results: List[Tuple[int, int]]) -> np.ndarray:
    if not results:
        return np.zeros((0, 2), dtype=np.int64)
    arr = np.asarray(sorted(set(_ordered(a, b) for a, b in results)), dtype=np.int64)
    return arr
