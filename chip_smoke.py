#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, so the script exits non-zero):

1. Device and build: the card's name and power limit, torch and CUDA
   versions, and the time to build every CUDA kernel (one ``nvcc`` per
   source, all started together).
2. Kernel parity: each kernel against its plain PyTorch version on the card,
   at the main path's shape (a 4096 x 4096 block pair of real data, W = 4)
   and over a sweep (odd sizes, W in {1, 128}, self-join, cosine keys, the
   cutoff, empty rows).  Results must be exactly equal; each kernel is then
   timed with CUDA events (median after warm-up) beside its plain version.
3. Slice parity: the blocked join on the card (``compaction="device"``)
   against the port's CPU path on a 10,000-set ZIPF collection with planted
   duplicates; ``naive_join`` on the card against the card's blocked join on
   a 3,000-set subset.  Pairs and ``JoinStats`` must be identical.
4. Full size, the main path: self-joins of the paper's ZIPF (100,000 sets,
   Poisson(50) sizes, 101,584 tokens, 1,000 planted clusters of 3 at Jaccard
   0.9; tau = 0.8) and UNIFORM (100,000 sets, Poisson(10) sizes, 220 tokens;
   tau = 0.5) collections, b = 128, block = 4096, ``compaction="device"``.
   Each kernel's launch counter is zeroed before and read after these two
   joins.  Both joins must agree with ``compaction="host"``.

The last three lines of standard output are the card's name and power
limit, the ``{"kernels": [...]}`` record and the ``{"ok": true, ...}``
result.  Exits non-zero without a result when no CUDA device is available.
Data is made from ``--seed``; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# float32 rate outside the tensor cores, which also caps 32-bit integer
# work (XOR, popcount, compare) at best.  The bound is the least time the
# card could take for the work: the larger of bytes/bandwidth and ops/rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
VERDICT_OPS = 10   # per pair: 2 positivity + 2 cutoff tests, sum, sub, shift, 2 min, compare
WINDOW_OPS = 4     # per pair: two window compares and their conjunction, the triangle

MAIN = dict(sim="jaccard", b=128, block=4096)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the card, each call timed alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build() -> float:
    from repro_torch.kernels import _build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = _build.build()
    seconds = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {seconds:.2f} s")
    for name in libs:
        for line in (_build.build_dir() / f"lib{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return seconds


def set_operands(rng, nr, ns, b, dev, *, universe=150, max_len=60):
    """Bitmaps (Xor, int32[n, b/32]) and sizes of random sets drawn from a
    small universe, so that many pairs overlap and the verdict keeps some;
    every fourth set is empty."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core.constants import PAD_TOKEN

    def side(n):
        lens = rng.integers(1, max_len, n).astype(np.int32)
        lens[::4] = 0
        toks = np.full((n, max_len), PAD_TOKEN, np.int32)
        for i, l in enumerate(lens):
            toks[i, :l] = np.sort(rng.choice(universe, size=l, replace=False))
        t, l = torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev)
        return bm.generate_bitmaps(t, l, b, method="xor"), l

    (wr, lr), (ws, ls) = side(nr), side(ns)
    return wr, ws, lr, ls


def phase_kernels(seed: int, main_prep) -> list[dict]:
    """Exact parity of each kernel with its plain version, then timing."""
    from repro_torch.core import bounds, expected, verify
    from repro_torch.kernels import bitmap_filter, compaction, ref
    from repro_torch.core.constants import COSINE

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)

    def check(sim, tau, wr, ws, lr, ls, *, self_join, cutoff, tile=256):
        lo, hi = bounds.length_window_int(sim, tau, lr.cpu().numpy())
        lo, hi = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
        table = ref.prune_table_for(sim, tau, lr, ls)
        kp = sim == COSINE
        got = bitmap_filter.candidate_matrix_cuda(
            wr, ws, lr, ls, table, key_prod=kp, self_join=self_join, cutoff=cutoff)
        want = ref.candidate_matrix_ref(wr, ws, lr, ls, sim=sim, tau=tau,
                                        self_join=self_join, cutoff=cutoff, table=table)
        err_c = int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) if got.numel() else 0
        cw, cc = compaction.count_candidates_cuda(
            wr, ws, lr, ls, lo, hi, table, key_prod=kp, self_join=self_join,
            cutoff=cutoff, tile_r=tile, tile_s=tile)
        rw, rc = ref.count_candidates_ref(wr, ws, lr, ls, lo, hi, sim=sim, tau=tau,
                                          self_join=self_join, cutoff=cutoff,
                                          tile_r=tile, tile_s=tile, table=table)
        err_n = max(int((cw - rw).abs().max()), int((cc - rc).abs().max())) if cw.numel() else 0
        torch.cuda.synchronize()
        if err_c or err_n or not (torch.equal(got, want) and torch.equal(cw, rw)
                                  and torch.equal(cc, rc)):
            raise AssertionError(f"kernel != plain version: {sim} {tau} "
                                 f"{list(wr.shape)}x{list(ws.shape)} self_join={self_join} "
                                 f"cutoff={cutoff} errs={err_c},{err_n}")
        return err_c, err_n, int(want.sum()), int(rc.sum())

    # The sweep of the CPU tests: odd sizes, W in {1, 4, 128}, self-join,
    # every key kind, the cutoff hit and not, empty rows, tiles that do not
    # divide the grid.
    for (nr, ns, w, sim, tau, sj, cutoff, tile) in [
            (333, 517, 1, "jaccard", 0.6, False, 1 << 30, 256),
            (517, 517, 4, "cosine", 0.4, True, 1 << 30, 256),
            (300, 200, 128, "dice", 0.3, False, 40, 64),
            (257, 65, 128, "overlap", 3.0, True, 1 << 30, 32),
            (1000, 999, 4, "jaccard", 0.3, False, 20, 256)]:
        wr, ws, lr, ls = set_operands(rng, nr, ns, 32 * w, dev)
        if sj:
            ws, ls = wr, lr
        errs = check(sim, tau, wr, ws, lr, ls, self_join=sj, cutoff=cutoff, tile=tile)
        log(f"parity sweep {nr}x{ns} W={w} {sim} tau={tau} self_join={sj} "
            f"cutoff={cutoff} tile={tile}: exact, {errs[2]} candidates")

    # The main path's shape: the first two 4096-row blocks of real data.
    tau = 0.8
    words = main_prep.bitmap_words(MAIN["b"], "xor")
    _, lengths = main_prep.device_arrays()
    blk = MAIN["block"]
    wr, ws = words[:blk], words[blk:2 * blk]
    lr, ls = lengths[:blk], lengths[blk:2 * blk]
    cutoff = expected.cutoff_point("xor", MAIN["b"], tau)
    errs = check("jaccard", tau, wr, ws, lr, ls, self_join=False, cutoff=cutoff)
    diag = check("jaccard", tau, wr, wr, lr, lr, self_join=True, cutoff=cutoff)
    log(f"parity main shape {blk}x{blk} W={wr.shape[1]}: exact; off-diagonal block "
        f"{errs[2]} candidates ({errs[3]} in the window), diagonal block {diag[2]} "
        f"({diag[3]})")

    table = verify.prune_table_dev("jaccard", tau, main_prep.max_len, main_prep.max_len, dev)
    lo, hi = (torch.from_numpy(a).to(dev) for a in
              bounds.length_window_int("jaccard", tau, lr.cpu().numpy()))
    kw = dict(key_prod=False, self_join=False, cutoff=cutoff)
    ms_c = cuda_ms(lambda: bitmap_filter.candidate_matrix_cuda(wr, ws, lr, ls, table, **kw), 50)
    ms_n = cuda_ms(lambda: compaction.count_candidates_cuda(
        wr, ws, lr, ls, lo, hi, table, tile_r=256, tile_s=256, **kw), 50)
    rkw = dict(sim="jaccard", tau=tau, self_join=False, cutoff=cutoff, table=table)
    plain_c = cuda_ms(lambda: ref.candidate_matrix_ref(wr, ws, lr, ls, **rkw), 10)
    plain_n = cuda_ms(lambda: ref.count_candidates_ref(wr, ws, lr, ls, lo, hi, **rkw), 10)

    pairs, w = blk * blk, wr.shape[1]
    in_bytes = 2 * blk * w * 4 + 2 * blk * 4 + table.numel() * 4
    b_c = bound_ms(in_bytes + pairs, pairs * (3 * w + VERDICT_OPS))
    b_n = bound_ms(in_bytes + 2 * blk * 4 + 2 * (blk // 256) ** 2 * 4,
                   pairs * (3 * w + VERDICT_OPS + WINDOW_OPS))
    log(f"timing at {blk}x{blk} W={w}: candidate_matrix {ms_c:.4f} ms (plain {plain_c:.3f} ms, "
        f"bound {b_c[0]:.4f} ms by {b_c[1]}); count_candidates {ms_n:.4f} ms "
        f"(plain {plain_n:.3f} ms, bound {b_n[0]:.4f} ms by {b_n[1]})")
    return [
        {"name": "candidate_matrix", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitmap_filter.cu",
         "replaces": "src/repro/kernels/bitmap_filter.py:151", "launches": 0,
         "max_abs_err": errs[0], "ms": ms_c, "plain_ms": plain_c,
         "bound_ms": b_c[0], "bound_by": b_c[1], "library_ms": None},
        {"name": "count_candidates", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/compaction.cu",
         "replaces": "src/repro/kernels/compaction.py:52", "launches": 0,
         "max_abs_err": errs[1], "ms": ms_n, "plain_ms": plain_n,
         "bound_ms": b_n[0], "bound_by": b_n[1], "library_ms": None},
    ]


def _join(prep, tau, compaction):
    from repro_torch.core import join

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairs, stats = join.blocked_bitmap_join_prepared(
        prep, sim=MAIN["sim"], tau=tau, b=MAIN["b"], block=MAIN["block"],
        compaction=compaction, return_stats=True)
    torch.cuda.synchronize()
    return pairs, stats, time.perf_counter() - t0


def _same(a, b, what):
    (pa, sa), (pb, sb) = a, b
    if not np.array_equal(pa, pb) or sa.to_dict() != sb.to_dict():
        raise AssertionError(f"{what}: {len(pa)} vs {len(pb)} pairs\n{sa}\n{sb}")


def phase_slice(col) -> None:
    from repro_torch.core import join
    from repro_torch.core.collection import Collection

    tau = 0.8
    kw = dict(sim=MAIN["sim"], tau=tau, b=MAIN["b"], block=MAIN["block"],
              compaction="device", return_stats=True)
    t0 = time.perf_counter()
    gpu = join.blocked_bitmap_join(col, **kw, device="cuda")
    t1 = time.perf_counter()
    cpu = join.blocked_bitmap_join(col, **kw, device="cpu")
    t2 = time.perf_counter()
    _same(gpu, cpu, "card vs CPU blocked join")
    log(f"slice parity {col.num_sets} sets: card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s, "
        f"{len(gpu[0])} pairs, identical; stats {json.dumps(gpu[1].to_dict())}")

    sub = Collection(tokens=col.tokens[:3000], lengths=col.lengths[:3000])
    oracle = join.naive_join(sub, MAIN["sim"], tau, device="cuda")
    got = join.blocked_bitmap_join(sub, **kw, device="cuda")[0]
    if not np.array_equal(oracle, got):
        raise AssertionError(f"naive_join {len(oracle)} pairs vs blocked {len(got)}")
    log(f"naive_join parity {sub.num_sets} sets: {len(oracle)} pairs, identical")


def phase_full(seed: int) -> dict:
    from repro_torch.core import engine
    from repro_torch.data.collections import uniform_collection, with_duplicates, zipf_collection
    from repro_torch.kernels import bitmap_filter, compaction

    t0 = time.perf_counter()
    zipf = with_duplicates(zipf_collection(n_sets=100_000, seed=seed), n_clusters=1000,
                           cluster_size=3, jaccard=0.9, seed=seed)
    uniform = uniform_collection(n_sets=100_000, seed=seed)
    cells = [("ZIPF", engine.prepare(zipf, "cuda"), 0.8),
             ("UNIFORM", engine.prepare(uniform, "cuda"), 0.5)]
    log(f"full size: generated and prepared {zipf.num_sets} + {uniform.num_sets} sets "
        f"in {time.perf_counter() - t0:.1f} s (set-up, not timed)")

    # The main path: counters zeroed just before, read just after.
    bitmap_filter.candidate_matrix_cuda.launches = 0
    compaction.count_candidates_cuda.launches = 0
    runs = {name: _join(prep, tau, "device") for name, prep, tau in cells}
    launches = {"candidate_matrix": bitmap_filter.candidate_matrix_cuda.launches,
                "count_candidates": compaction.count_candidates_cuda.launches}
    log(f"main path launches: {json.dumps(launches)}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    for name, prep, tau in cells:
        pairs, stats, cold = runs[name]
        _, _, warm = _join(prep, tau, "device")
        hp, hs, host_s = _join(prep, tau, "host")
        _same((pairs, stats), (hp, hs), f"{name} device vs host compaction")
        log(f"{name} tau={tau} n={prep.num_sets}: device compaction cold {cold:.3f} s "
            f"(incl. bitmap build), warm {warm:.3f} s = "
            f"{stats.total_pairs / warm:.4g} window pairs/s; host compaction "
            f"{host_s:.3f} s; identical; stats {json.dumps(stats.to_dict())}")
        if name == "ZIPF" and stats.verified_true < 2000:
            raise AssertionError(f"ZIPF found {stats.verified_true} < 2000 planted pairs")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import engine
    from repro_torch.data.collections import with_duplicates, zipf_collection

    log(smi_line())
    phase_build()
    col = with_duplicates(zipf_collection(n_sets=10_000, seed=args.seed), n_clusters=100,
                          cluster_size=3, jaccard=0.9, seed=args.seed)
    kernels = phase_kernels(args.seed, engine.prepare(col, "cuda"))
    phase_slice(col)
    launches = phase_full(args.seed)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
