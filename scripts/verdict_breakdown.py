#!/usr/bin/env python3
"""Where the tensor-core verdict kernels' time goes, on one GPU.

    PYTHONPATH=src python3 scripts/verdict_breakdown.py [--seed N]

``count_candidates_mxu`` and ``candidate_matrix_mxu`` share one main loop
(``src/repro_torch/kernels/csrc/planes_mma.cuh``).  This script

1. builds variants of that header with parts of the kernel switched off
   (the epilogue, the wgmma product, the bit expansion, the prune-table
   load, and the first three together) beside the real one, and times each
   kernel of each variant at the blocked join's 4096 x 4096 block pair of
   real ZIPF data (the first two blocks of 10,200 length-sorted sets) at
   b = 128 and 1024; the variants compute wrong answers by design, and only
   their device times are printed;
2. times both real kernels over a size sweep (1,024 to 16,384 rows a side,
   random words, sorted lengths; the count with its length window and
   with a window that passes every pair), which separates the cost of a
   launch from the cost of a pair.

Device times are ``chip_smoke.cuda_ms``: back-to-back launches behind a
spin kernel, the median of three runs.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# Each switch replaces one line of the header; a default of 1 keeps it.
SWITCHES = [
    ("EPILOGUE", "    if (kCount) {\n      if (!skip) {", "    if (kCount) {\n      if (!skip && EPILOGUE) {"),
    ("EPILOGUE", "      } else if (tri) {\n        candidate_epilogue<true>",
     "      } else if (!EPILOGUE) {\n      } else if (tri) {\n        candidate_epilogue<true>"),
    ("PRODUCT", "          hopper::wgmma_m64n128k32_s8(acc,", "          if (PRODUCT) hopper::wgmma_m64n128k32_s8(acc,"),
    ("EXPAND", "          expand_word(dst[q], tid, k, cur[q][k]);",
     "          if (EXPAND) expand_word(dst[q], tid, k, cur[q][k]);"),
    ("TABLE", "  const int t = __ldg(table + static_cast<unsigned>(ka * ls + kb));",
     "  const int t = TABLE ? __ldg(table + static_cast<unsigned>(ka * ls + kb)) : (ka * ls + kb) >> 1;"),
]
VARIANTS = {"full": {}, "no epilogue": {"EPILOGUE": 0}, "no product": {"PRODUCT": 0},
            "no expansion": {"EXPAND": 0}, "no table load": {"TABLE": 0},
            "none of the three": {"EPILOGUE": 0, "PRODUCT": 0, "EXPAND": 0}}
C, I = ctypes.c_void_p, ctypes.c_int


def build_variant(out: Path, flags: dict) -> tuple:
    """The two kernels' entry points of one variant, compiled as the port's
    build (`_build`) compiles them."""
    from repro_torch.kernels import _build

    shutil.copytree(_build.CSRC, out)
    header = (out / "planes_mma.cuh").read_text()
    for _, old, new in SWITCHES:
        if old not in header:
            raise RuntimeError(f"planes_mma.cuh no longer has the line {old.strip()!r}")
        header = header.replace(old, new)
    (out / "planes_mma.cuh").write_text(header)
    defines = [f"-D{name}={flags.get(name, 1)}" for name in {s[0] for s in SWITCHES}]
    fns = []
    for source, entry, n_ptr_in, n_int, n_ptr_out in (
            ("compaction", "count_candidates_mxu_launch", 7, 8, 3),
            ("bitmap_filter", "candidate_matrix_mxu_launch", 5, 6, 2)):
        lib = out / f"lib{source}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(lib),
                               str(out / f"{source}.cu")], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source}.cu:\n{proc.stdout}{proc.stderr}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = [C] * n_ptr_in + [I] * n_int + [C] * n_ptr_out
        fn.restype = I
        fns.append(fn)
    return tuple(fns)


def operands(wr, ws, lr, ls, tau, cutoff, max_len):
    from repro_torch.core import bounds, verify

    table = verify.prune_table_dev("jaccard", tau, max_len, max_len, wr.device)
    lo, hi = (torch.from_numpy(a).to(wr.device)
              for a in bounds.length_window_int("jaccard", tau, lr.cpu().numpy()))
    return table, lo, hi


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("verdict_breakdown: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, smi_line
    from repro_torch.core import engine, expected
    from repro_torch.data.collections import with_duplicates, zipf_collection
    from repro_torch.kernels import bitmap_filter, compaction

    print(smi_line(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="verdict_breakdown_"))
    try:
        with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
            built = dict(zip(VARIANTS, pool.map(
                lambda kv: build_variant(tmp / str(kv[0]).replace(" ", "_"), kv[1]),
                VARIANTS.items())))
        dev = torch.device("cuda")
        col = with_duplicates(zipf_collection(n_sets=10_000, seed=args.seed), n_clusters=100,
                              cluster_size=3, jaccard=0.9, seed=args.seed)
        prep = engine.prepare(col, "cuda")
        _, lengths = prep.device_arrays()
        blk, tau = 4096, 0.8
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        for b in (128, 1024):
            words = prep.bitmap_words(b, "xor")
            wr, ws, lr, ls = words[:blk], words[blk:2 * blk], lengths[:blk], lengths[blk:2 * blk]
            cutoff = expected.cutoff_point("xor", b, tau)
            table, lo, hi = operands(wr, ws, lr, ls, tau, cutoff, prep.max_len)
            counts = torch.zeros((2, blk // 256, blk // 256), dtype=torch.int32, device=dev)
            verdicts = torch.empty((blk, blk), dtype=torch.bool, device=dev)
            times = {}
            for name, (count, cand) in built.items():
                times[name] = [round(1e3 * cuda_ms(f, 50), 1) for f in (
                    lambda: count(wr.data_ptr(), ws.data_ptr(), lr.data_ptr(), ls.data_ptr(),
                                  lo.data_ptr(), hi.data_ptr(), table.data_ptr(), blk, blk,
                                  b // 32, 0, 0, cutoff, 256, 256, counts[0].data_ptr(),
                                  counts[1].data_ptr(), stream()),
                    lambda: cand(wr.data_ptr(), ws.data_ptr(), lr.data_ptr(), ls.data_ptr(),
                                 table.data_ptr(), blk, blk, b // 32, 0, 0, cutoff,
                                 verdicts.data_ptr(), stream()))]
            print(f"variants at {blk}x{blk} b={b} (ZIPF), device us (count, verdict): {times}",
                  flush=True)

        rng = np.random.default_rng(args.seed)
        for w in (4, 32):
            for n in (1024, 2048, 4096, 8192, 16384):
                wr, ws = (torch.from_numpy(rng.integers(0, 2**32, (n, w), dtype=np.uint32)
                                           .view(np.int32)).to(dev) for _ in range(2))
                lr, ls = (torch.from_numpy(np.sort(rng.integers(1, 60, n)).astype(np.int32))
                          .to(dev) for _ in range(2))
                table, lo, hi = operands(wr, ws, lr, ls, tau, 1 << 30, 60)
                kw = dict(key_prod=False, self_join=False, cutoff=1 << 30)
                every = (torch.zeros_like(lo), torch.full_like(hi, 1 << 30))
                t = [cuda_ms(f, 20) for f in (
                    lambda: bitmap_filter.candidate_matrix_mxu_cuda(wr, ws, lr, ls, table, **kw),
                    lambda: compaction.count_candidates_mxu_cuda(
                        wr, ws, lr, ls, lo, hi, table, tile_r=256, tile_s=256, **kw),
                    lambda: compaction.count_candidates_mxu_cuda(
                        wr, ws, lr, ls, *every, table, tile_r=256, tile_s=256, **kw))]
                per = [1e3 * x / (n * n / 1e6) for x in t]
                print(f"sweep W={w} {n}x{n}: verdict {1e3 * t[0]:.1f} us ({per[0]:.3f} us a "
                      f"million pairs), count {1e3 * t[1]:.1f} us ({per[1]:.3f}), count with "
                      f"every pair in the window {1e3 * t[2]:.1f} us ({per[2]:.3f})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
