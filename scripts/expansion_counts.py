#!/usr/bin/env python3
"""How much the indexed driver expands on the full-size collections.

    PYTHONPATH=src python3 scripts/expansion_counts.py [--seed N]

For each collection and τ of the port's full-size runs, prints the plan
``JoinPlanner`` picks for one GPU and the indexed driver's host count
prepass (``index/candidates.py::_expansion_count_host``, Jaccard, b = 128,
4096-probe chunks): the postings entries expanded in all, the largest
chunk, and how many chunks exceed ``_MAX_AUTO_CAPACITY`` (2^26) and so go
to the dense fallback.  These are counts, computed on the host in numpy;
no device is needed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    from repro_torch.core import engine
    from repro_torch.core.plan import JoinPlanner
    from repro_torch.data.collections import (skewed_collection, uniform_collection,
                                              with_duplicates, zipf_collection)
    from repro_torch.index import candidates

    def planted(col):
        return with_duplicates(col, n_clusters=1000, cluster_size=3, jaccard=0.9,
                               seed=args.seed)

    cells = [
        ("ZIPF 100k + 1000x3 planted", lambda: planted(zipf_collection(100_000, seed=args.seed)), (0.8,)),
        ("UNIFORM 100k", lambda: uniform_collection(100_000, seed=args.seed), (0.6,)),
        ("SKEWED 100k + 1000x3 planted", lambda: planted(skewed_collection(100_000, seed=args.seed)),
         (0.8, 0.6)),
    ]
    block = 4096
    for name, make, taus in cells:
        prep = engine.prepare(make(), "cpu")
        for tau in taus:
            plan = JoinPlanner().plan("jaccard", tau, prep.num_sets, backend="gpu", n_devices=1)
            post = prep.postings("jaccard", tau)
            ps, lp = candidates.probe_prefix_lengths(prep, "jaccard", tau)
            lo, hi, _, _ = prep.length_window_int("jaccard", tau)
            chunks = [candidates._expansion_count_host(
                post, prep.tokens[c0:c0 + block], ps[c0:c0 + block], lo[c0:c0 + block],
                hi[c0:c0 + block], lp, post.max_len + 1)
                for c0 in range(0, prep.num_sets, block)]
            print(json.dumps({
                "collection": name, "n_sets": prep.num_sets, "tau": tau,
                "planner": plan.driver, "postings_expanded": sum(chunks),
                "largest_chunk": max(chunks), "chunks": len(chunks),
                "chunks_over_2^26": sum(c > candidates._MAX_AUTO_CAPACITY for c in chunks),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
