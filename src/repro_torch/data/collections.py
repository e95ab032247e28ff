"""Synthetic collection generators following the paper's methodology (§5).

A numpy copy of ``repro.data.collections`` (same seeds, same sets), so the
PyTorch port can build its inputs without importing the JAX package.  The
paper's UNIFORM and ZIPF collections are generated with Poisson set sizes and
uniform / Zipf token draws.

``with_duplicates`` plants near-duplicate clusters with a controlled Jaccard
level — used by the join tests and ``chip_smoke.py`` (ground truth
guaranteed to be non-empty).
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
