#!/usr/bin/env python3
"""Near-duplicate dedup of an LM corpus on the card: the paper's technique as
a first-class data-pipeline stage (the PyTorch twin of the JAX package's
``examples/dedup_pipeline.py``, with the same inputs and output lines).

    PYTHONPATH=src python scripts/dedup_pipeline_torch.py              # on the card
    PYTHONPATH=src python scripts/dedup_pipeline_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device for the joins (default: the card; raises "
                             "without one)")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.data.collections import uniform_collection, with_duplicates
    from repro_torch.data.dedup import dedup_collection, dedup_documents

    # Document-level: shingle -> bitmap join -> union-find -> keep one per cluster.
    docs = [
        "the quick brown fox jumps over the lazy dog",
        "the quick brown fox jumps over the lazy cat",
        "a completely different training document about TPUs",
        "the quick brown fox jumps over the lazy dog!",
        "exact set similarity joins with bitwise operations",
    ] * 200  # simulate a crawl with heavy duplication
    kept, res = dedup_documents(docs, tau=0.5, device=args.device)
    print(f"{len(docs)} docs -> {len(kept)} after exact near-dup removal "
          f"(pruned {res.stats.filter_ratio:.1%} of candidate pairs via bitmaps)")

    # Token-set-level (pre-tokenised corpora).
    base = uniform_collection(n_sets=5000, avg_size=15, n_tokens=2000, seed=3)
    col = with_duplicates(base, n_clusters=100, cluster_size=4, jaccard=0.92, seed=4)
    res = dedup_collection(col, tau=0.85, b=128, device=args.device)
    print(f"{col.num_sets} sets -> keep {len(res.keep)}, drop {len(res.drop)} "
          f"({len(res.pairs)} similar pairs found)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
