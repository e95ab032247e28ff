"""Synthetic collection generators following the paper's methodology (§5).

A numpy copy of ``repro.data.collections`` (same seeds, same sets), so the
PyTorch port can build its inputs without importing the JAX package.  The
paper's UNIFORM and ZIPF collections are generated with Poisson set sizes and
uniform / Zipf token draws; the DBLP-like one is matched on the published
statistics of the paper's Table 4 (set-size distribution family + number of
distinct tokens).

``with_duplicates`` plants near-duplicate clusters with a controlled Jaccard
level — used by the join tests and ``chip_smoke.py`` (ground truth
guaranteed to be non-empty).

``near_duplicate_lists`` and ``shared_token_lists`` are the port's own (no
counterpart in the JAX package): the small inputs on which the indexed
driver's stage kernels are held against their plain versions, by the card
tests and ``chip_smoke.py`` alike.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.collection import Collection, from_lists, preprocess


def _draw_sets(rng, n_sets: int, avg_size: float, n_tokens: int,
               dist: str, zipf_a: float = 1.2):
    sizes = np.maximum(rng.poisson(avg_size, size=n_sets), 1)
    sets = []
    for sz in sizes:
        if dist == "uniform":
            toks = rng.integers(0, n_tokens, size=2 * sz + 8)
        elif dist == "zipf":
            toks = (rng.zipf(zipf_a, size=4 * sz + 16) - 1) % n_tokens
        else:
            raise ValueError(dist)
        u = np.unique(toks)[:sz]
        if len(u) == 0:
            u = np.array([int(rng.integers(0, n_tokens))])
        sets.append(u.tolist())
    return sets


def uniform_collection(n_sets: int = 1000, avg_size: float = 10.0,
                       n_tokens: int = 220, seed: int = 0) -> Collection:
    """Paper's UNIFORM: Poisson sizes (avg ~10), 220 distinct tokens."""
    rng = np.random.default_rng(seed)
    return preprocess(from_lists(_draw_sets(rng, n_sets, avg_size, n_tokens, "uniform")))


def zipf_collection(n_sets: int = 1000, avg_size: float = 50.0,
                    n_tokens: int = 101_584, seed: int = 0) -> Collection:
    """Paper's ZIPF: Poisson sizes (avg ~50), Zipf-distributed tokens."""
    rng = np.random.default_rng(seed)
    return preprocess(from_lists(_draw_sets(rng, n_sets, avg_size, n_tokens, "zipf")))


def skewed_collection(n_sets: int = 1000, avg_size: float = 9.0,
                      n_tokens: int = 100_000, zipf_a: float = 1.5,
                      seed: int = 0) -> Collection:
    """Zipf-skewed token frequencies *without* the head-only truncation bias.

    ``zipf_collection`` keeps the first (smallest-valued == most frequent)
    tokens of each draw, which at small set sizes collapses every set onto
    the distribution head and yields a degenerate, near-all-duplicates
    collection.  Here each set keeps a *random* subset of its draw, so head
    tokens are shared across many sets (real skew for prefix indexes to
    cope with) while tail tokens keep sets distinct — the shape the
    indexed-vs-blocked comparisons use.
    """
    rng = np.random.default_rng(seed)
    sizes = np.maximum(rng.poisson(avg_size, size=n_sets), 1)
    sets = []
    for sz in sizes:
        u = np.unique((rng.zipf(zipf_a, size=4 * sz + 16) - 1) % n_tokens)
        sets.append(rng.permutation(u)[:sz].tolist())
    return preprocess(from_lists(sets))


def dblp_like_collection(n_sets: int = 1000, seed: int = 0) -> Collection:
    """DBLP-like: symmetric size distribution around ~106, 3801 tokens."""
    rng = np.random.default_rng(seed)
    sizes = np.clip(rng.normal(106, 25, size=n_sets), 8, 400).astype(int)
    sets = []
    for sz in sizes:
        toks = (rng.zipf(1.15, size=4 * sz + 16) - 1) % 3801
        u = np.unique(toks)[:sz]
        sets.append(u.tolist())
    return preprocess(from_lists(sets))


def with_duplicates(
    base: Collection,
    n_clusters: int = 20,
    cluster_size: int = 3,
    jaccard: float = 0.9,
    seed: int = 0,
) -> Collection:
    """Plant near-duplicate clusters at a target Jaccard into a collection."""
    rng = np.random.default_rng(seed)
    rows = base.as_lists()
    universe = max(max(r) for r in rows if r) + 1
    for _ in range(n_clusters):
        src = rows[int(rng.integers(0, len(rows)))]
        n = len(src)
        # |r ∩ s| / |r ∪ s| = j with |r| = |s| = n  =>  overlap = 2jn/(1+j)
        keep = max(int(round(2 * jaccard * n / (1 + jaccard))), 1)
        keep = min(keep, n)
        for _ in range(cluster_size - 1):
            kept = list(rng.choice(src, size=keep, replace=False))
            extra = [int(rng.integers(universe, universe + 10 * n))
                     for _ in range(n - keep)]
            rows.append(sorted(set(kept + extra)))
    return preprocess(from_lists(rows))


def near_duplicate_lists(n: int, seed: int, universe: int = 110) -> list[list[int]]:
    """``n`` sets of 2 to 12 tokens, each a copy of one of ``n // 4`` random
    bases with, half of the time, one token dropped; then one empty set.  A
    probe chunk of these expands, generates, passes the bitmap and verifies
    at every similarity and threshold."""
    rng = np.random.default_rng(seed)
    base = [rng.choice(universe, size=rng.integers(2, 13), replace=False).tolist()
            for _ in range(max(n // 4, 1))]
    sets = []
    for _ in range(n):
        src = list(base[int(rng.integers(len(base)))])
        if len(src) > 2 and rng.random() < 0.5:
            src.pop(int(rng.integers(len(src))))
        sets.append(src)
    return sets + [[]]


def shared_token_lists(n: int = 1500, seed: int = 31) -> list[list[int]]:
    """``n`` sets of 4 to 9 tokens that all hold token 0, so a probe's
    prefix position on token 0 expands into one segment of about ``n``
    postings, longer than a stage kernel's block."""
    rng = np.random.default_rng(seed)
    return [[0] + rng.choice(np.arange(1, 60), size=int(rng.integers(3, 9)),
                             replace=False).tolist() for _ in range(n)]
