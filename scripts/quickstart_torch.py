#!/usr/bin/env python3
"""Quickstart: exact set-similarity joins (self and R×S) with the Bitmap
Filter, on the card (the PyTorch twin of the JAX package's
``examples/quickstart.py``, with the same inputs and output lines).

    PYTHONPATH=src python scripts/quickstart_torch.py              # on the card
    PYTHONPATH=src python scripts/quickstart_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device for the joins (default: the card; raises "
                             "without one)")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core import JACCARD, JoinEngine, JoinPlanner, from_lists, preprocess_rs
    from repro_torch.core.collection import Collection
    from repro_torch.core.join import blocked_bitmap_join, naive_join
    from repro_torch.data.collections import uniform_collection, with_duplicates

    dev = args.device

    # 1. Build a collection (or bring your own token sets).
    base = uniform_collection(n_sets=3000, avg_size=12, n_tokens=800, seed=0)
    col = with_duplicates(base, n_clusters=40, cluster_size=3, jaccard=0.9, seed=1)
    print(f"collection: {col.num_sets} sets, max |r| = {col.max_len}")

    # 2. Exact join at Jaccard >= 0.8, accelerated by the Bitmap Filter
    #    (Bitmap-Combined generation, Eq. 2 pruning, cutoff from Eq. 4-6).
    pairs, stats = blocked_bitmap_join(col, JACCARD, 0.8, b=128, return_stats=True, device=dev)
    print(f"similar pairs: {len(pairs)}")
    print(f"bitmap filter pruned {stats.filter_ratio:.1%} of length-surviving pairs")
    print(f"verification precision: {stats.precision:.1%}")

    # 3. It is exact: identical to the naive O(N^2) oracle.
    assert np.array_equal(pairs, naive_join(col, JACCARD, 0.8, device=dev))
    print("matches the naive oracle exactly — no false negatives, no false positives")

    # 4. Two-collection R×S join: pairs come back as (r_index, s_index);
    #    preprocess_rs relabels both sides with one shared token order.
    rng = np.random.default_rng(2)
    shard_a = [rng.choice(800, size=rng.integers(4, 16), replace=False).tolist()
               for _ in range(1500)]
    shard_b = [rng.choice(800, size=rng.integers(4, 16), replace=False).tolist()
               for _ in range(1000)]
    shard_b[:20] = shard_a[:20]  # overlap between the shards
    col_r, col_s = preprocess_rs(from_lists(shard_a), from_lists(shard_b))
    rs_pairs, rs_stats = blocked_bitmap_join(col_r, col_s, JACCARD, 0.8, b=128,
                                             return_stats=True, device=dev)
    print(f"R×S join: {len(rs_pairs)} cross-collection pairs, "
          f"filter ratio {rs_stats.filter_ratio:.1%}")
    assert np.array_equal(rs_pairs, naive_join(col_r, col_s, JACCARD, 0.8, device=dev))
    print("R×S matches the oracle exactly")

    # 5. The serving shape: prepare R once, stream probe batches against it;
    #    the corpus-side artifacts are built once (the build counters).
    engine = JoinEngine(col_r, JACCARD, 0.8, planner=JoinPlanner(naive_cells=0), device=dev)
    print(engine.plan.describe())
    half = col_s.num_sets // 2
    batch_1 = Collection(tokens=col_s.tokens[:half], lengths=col_s.lengths[:half])
    batch_2 = Collection(tokens=col_s.tokens[half:], lengths=col_s.lengths[half:])
    p1, s1 = engine.probe(batch_1)
    p2, s2 = engine.probe(batch_2)
    print(f"probe 1: {len(p1)} pairs (filter ratio {s1.filter_ratio:.1%}); "
          f"probe 2: {len(p2)} pairs")
    builds = engine.prepared.builds
    assert builds["sort"] == 1 and builds["bitmap"] == 1  # built once, reused
    merged = np.concatenate([p1, p2 + np.array([0, half])], axis=0)
    merged = merged[np.lexsort((merged[:, 1], merged[:, 0]))]
    assert np.array_equal(merged, rs_pairs)
    print(f"streamed probes match the one-shot R×S join exactly; "
          f"corpus artifacts built once: {builds}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
