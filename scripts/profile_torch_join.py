#!/usr/bin/env python3
"""Where the time of the port's full-size device joins goes, on one GPU.

    PYTHONPATH=src python3 scripts/profile_torch_join.py [--seed N] [--out DIR] [--cells ...]

Builds the full-size cells of ``chip_smoke.py`` — the blocked path's ZIPF
(tau = 0.8) and UNIFORM (tau = 0.5), and the indexed path's SKEWED
(``skewed_collection`` of 100,000 sets + 1,000 planted clusters of 3 at
Jaccard 0.9; tau = 0.8 and 0.6); b = 128, block = 4096, device
compaction — and the wide-bitmap cells at b = 1024: ZIPF-1024 (the ZIPF
self-join through a ``CorpusStore`` with a pinned blocked plan) and
SERVE-1024 / SERVE-1024-DELTA (one flush of 512 single-set requests, shaped
as in ``chip_smoke.py``, through a ``JoinSession`` over the SKEWED store
planned by ``JoinPlanner(b=1024)``, without and with a 2,000-set delta).
It runs each once to warm it and once more timed, then
once under ``torch.profiler``, and prints per cell: both wall times, the
device's busy time (the sum of the times of the kernels that ran on it,
each counted once) and idle share during the profiled join, the device
time of the largest kernels and of each of the port's own CUDA kernels
(time, calls, and the mean per call; the tensor-core verdict kernels show
as ``planes_mma::planes_verdict_kernel<true>``, the count, and ``<false>``,
the verdict).  The SKEWED cells run
``JoinEngine``'s auto plan, which must be the indexed driver.  The Chrome
traces go to ``--out`` (default ``profile_traces/``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="profile_traces")
    cells = ["ZIPF", "UNIFORM", "SKEWED-0.8", "SKEWED-0.6", "ZIPF-1024", "SERVE-1024",
             "SERVE-1024-DELTA"]
    parser.add_argument("--cells", nargs="+", default=cells, choices=cells)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_join: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import mixed_delta, serve_requests
    from repro_torch.core import engine, join
    from repro_torch.core.plan import JoinPlan, JoinPlanner
    from repro_torch.data.collections import (skewed_collection, uniform_collection,
                                              with_duplicates, zipf_collection)
    from repro_torch.serve import JoinSession
    from repro_torch.store import CorpusStore, sum_stats

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    def skewed():
        return with_duplicates(skewed_collection(n_sets=100_000, seed=args.seed),
                               n_clusters=1000, cluster_size=3, jaccard=0.9, seed=args.seed)

    makers = {
        "ZIPF": (lambda: with_duplicates(zipf_collection(n_sets=100_000, seed=args.seed),
                                         n_clusters=1000, cluster_size=3, jaccard=0.9,
                                         seed=args.seed), 0.8),
        "UNIFORM": (lambda: uniform_collection(n_sets=100_000, seed=args.seed), 0.5),
        "SKEWED-0.8": (skewed, 0.8),
        "SKEWED-0.6": (skewed, 0.6),
    }
    makers["ZIPF-1024"] = (makers["ZIPF"][0], 0.8)
    makers["SERVE-1024"] = makers["SERVE-1024-DELTA"] = (skewed, 0.8)
    for name in args.cells:
        make, tau = makers[name]
        col = make()
        if name == "ZIPF-1024":
            store = CorpusStore(col, "jaccard", tau, device="cuda", plan=JoinPlan(
                driver="blocked", sim="jaccard", tau=tau, b=1024, block=4096,
                compaction="device"))
            prep, driver = store.base.prepared, "blocked"

            def run():
                return store.self_join(return_stats=True)
        elif name.startswith("SERVE"):
            store = CorpusStore(col, "jaccard", tau, planner=JoinPlanner(b=1024),
                                device="cuda")
            sess = JoinSession(store, max_batch=512)
            requests = serve_requests(col, args.seed, 512)
            sess.warm_buckets(requests)
            if name.endswith("DELTA"):
                sess.append(mixed_delta(col, skewed_collection(n_sets=2000, seed=args.seed + 40),
                                        args.seed + 41), compact=False)
            prep, driver = store.base.prepared, f"session over {store.plan.driver}"

            def run():
                tickets = [sess.submit(r) for r in requests]
                sess.flush()
                return None, sum_stats([t.stats for t in tickets])
        elif name.startswith("SKEWED"):
            eng = engine.JoinEngine(col, "jaccard", tau, device="cuda")
            if eng.plan.driver != "indexed":
                raise AssertionError(f"SKEWED planned {eng.plan.describe()}")
            prep, driver = eng.prepared, "indexed"

            def run():
                return eng.self_join(return_stats=True)
        else:
            prep, driver = engine.prepare(col, "cuda"), "blocked"
            kw = dict(sim="jaccard", tau=tau, b=128, block=4096, compaction="device",
                      return_stats=True)

            def run():
                return join.blocked_bitmap_join_prepared(prep, **kw)
        run()  # warm: words, tables, postings, kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, stats = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(str(out / f"{name.lower()}_trace.json"))
        # Device-side events only: each aten op is also listed on the host
        # side with the time of the kernels it launched.
        by_kernel = {ev.key: (ev.self_device_time_total, ev.count)
                     for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA}
        busy_us = sum(us for us, _ in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
        own = {k.removeprefix("void ").split("(")[0]: (us, n) for k, (us, n) in by_kernel.items()
               if k.removeprefix("void ").startswith(("bitmap_join::", "bitplane::",
                                                      "planes_mma::"))}
        print(json.dumps({
            "cell": name, "driver": driver, "tau": tau, "n_sets": prep.num_sets,
            "wall_s": wall_plain, "wall_s_profiled": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "stats": stats.to_dict(),
            "kernels": len(by_kernel),
            "device_us_by_kernel": [{"kernel": k[:100], "us": us, "calls": n}
                                    for k, (us, n) in top],
            "own_kernels": [{"kernel": k, "us": us, "calls": n, "us_per_call": us / n}
                            for k, (us, n) in sorted(own.items())],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
