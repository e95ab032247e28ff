#!/usr/bin/env python3
"""The bitmap build's lane form in variants, built side by side and timed
in turns on one GPU.

    PYTHONPATH=src python3 scripts/bitmap_build_variants.py [--variants NAME ...]
        [--seed N] [--check-only]

The lane form of ``src/repro_torch/kernels/csrc/bitmap_build.cu`` (one lane
a set) is fixed at compile time by a few constants.  This script writes one
copy of the source per variant (``VARIANTS``, each a swap of one constant:
fewer or more positions read ahead; a lane's words in shared memory at
every width; a load, the OR / XOR and a store in place of the shared-memory
atomics for Set and Xor; more warps a block), compiles each with the port's
``nvcc`` flags, all in parallel, and prints each one's registers and
spills.  Then, on ``chip_smoke.py``'s collections (phase 4's ZIPF, 102,000
sets, as generated and in the length-sorted order a prepared collection
holds; UNIFORM) and on its serving-shaped batches
(``chip_smoke.build_serving_batch``: 16 and 512 ZIPF rows in a seeded
order, padded to a power-of-two width) and ZIPF's first 1,024 to 16,384
rows:

1. holds every variant's words equal to the plain version's
   (``ref.bitmap_build_ref``) bit for bit;
2. unless ``--check-only``, times, as device time (``chip_smoke.cuda_ms``),
   the shipped lane form, the warp form and each variant in turns, then
   the same in reverse.

Prints the card's name and power limit, a line per shape, and a JSON
summary last.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
C, I = ctypes.c_void_p, ctypes.c_int
LANE = 1   # the lane form's code in bitmap_build_launch
METHODS = {"set": 0, "xor": 1, "next": 2}


def ahead(reg: int, smem: int) -> list:
    return [("constexpr int kAheadReg = 8;", f"constexpr int kAheadReg = {reg};"),
            ("constexpr int kAheadSmem = 16;", f"constexpr int kAheadSmem = {smem};")]


# name -> [(a constant's line in the source, its replacement)]; "default"
# is the source (8 positions read ahead with the words in registers, 16 in
# shared memory; Set / Xor fold shared words by atomics).
VARIANTS = {
    "default": [],
    "ahead 4/16": ahead(4, 16),
    "ahead 16/16": ahead(16, 16),
    "ahead 8/32": ahead(8, 32),
    "smem words": [("constexpr int kRegWords = 8;", "constexpr int kRegWords = 0;")],
    "no atomics": [("constexpr bool kSmemAtomics = true;",
                    "constexpr bool kSmemAtomics = false;")],
    "8 warps": [("constexpr int kLaneWarps = 4;", "constexpr int kLaneWarps = 8;")],
}
WIDTHS = (128, 1024)
CROSSOVER_ROWS = (1024, 4096, 6144, 8192, 12288, 16384)


def variant_source(name: str) -> str:
    from repro_torch.kernels import _build

    text = (_build.CSRC / "bitmap_build.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer has {old!r} once")
        text = text.replace(old, new)
    return text


def build_variant(name: str, out: Path):
    """One variant's ``bitmap_build_launch`` and its lane kernels' ptxas
    lines (registers, spills)."""
    from repro_torch.kernels import _build

    tag = name.replace(" ", "_").replace("/", "-")
    src = out / f"bitmap_build_{tag}.cu"
    src.write_text(variant_source(name))
    lib = out / f"libbitmap_build_{tag}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).bitmap_build_launch
    fn.argtypes = [C, C, I, I, I, I, I, I, C, C]
    fn.restype = I
    lines, keep = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            # The lane kernels at b = 128 (4 words in registers) and 1,024.
            keep = next((k for k in ("ELi4ELb1EE", "ELi32ELb0EE") if "lane_kernel" in line
                         and k in line), None)
            if keep:
                method = "set xor next".split()[int(line.split("lane_kernelILi")[1][0])]
                lines.append(f"{'b=128' if keep.startswith('ELi4') else 'b=1024'} {method}")
        elif keep and any(w in line for w in ("registers", "spill", "stack")):
            lines.append(line.split("info    :")[-1].strip())
    return fn, "; ".join(lines)


def launcher(fn, tokens, lengths, b, method):
    """A call of one variant's lane form, allocating its words as the
    wrapper does."""
    n, l = tokens.shape
    code = METHODS[method]

    def run():
        out = torch.empty((n, b // 32), dtype=torch.int32, device=tokens.device)
        rc = fn(tokens.data_ptr(), lengths.data_ptr(), n, l, b, code, 0, LANE, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out
    return run


def shapes(seed: int) -> list:
    """(name, tokens, lengths, b, method) on the card."""
    from chip_smoke import ZIPF_CLUSTERS, build_serving_batch
    from repro_torch.data.collections import uniform_collection, with_duplicates, zipf_collection

    zipf = with_duplicates(zipf_collection(n_sets=100_000, seed=seed), **ZIPF_CLUSTERS,
                           seed=seed)
    uniform = uniform_collection(n_sets=100_000, seed=seed)
    order = np.argsort(zipf.lengths, kind="stable")

    def dev(toks, lens):
        return torch.from_numpy(np.ascontiguousarray(toks)).cuda(), torch.from_numpy(
            np.ascontiguousarray(lens)).cuda()

    z = dev(zipf.tokens, zipf.lengths)
    zs = dev(zipf.tokens[order], zipf.lengths[order])
    out = [(f"ZIPF b={b} {m}", *z, b, m) for b in WIDTHS for m in METHODS]
    out += [(f"ZIPF sorted b={b} {m}", *zs, b, m) for b in WIDTHS for m in ("xor", "next")]
    out.append(("UNIFORM b=128 next", *dev(uniform.tokens, uniform.lengths), 128, "next"))
    for rows in (16, 512):
        t, l = dev(*build_serving_batch(zipf, rows, seed))
        out += [(f"serving {rows} b=1024 {m}", t, l, 1024, m) for m in ("xor", "next")]
    for rows in CROSSOVER_ROWS:   # where Set / Xor's lane form starts to win
        t, l = dev(zipf.tokens[:rows], zipf.lengths[:rows])
        out += [(f"ZIPF first {rows} b={b} xor", t, l, b, "xor") for b in WIDTHS]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--check-only", action="store_true")
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, smi_line
    from repro_torch.kernels import _build, bitmap_build, ref

    print(smi_line(), flush=True)
    _build.build(["bitmap_build"])
    out = _build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    names = [n for n in args.variants if n != "default"]
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        built = dict(zip(names, pool.map(lambda n: build_variant(n, out), names)))
    for name, (_fn, info) in built.items():
        print(f"{name}: {info}", flush=True)

    summary = {"device": smi_line(), "shapes": {}}
    for label, tokens, lengths, b, method in shapes(args.seed):
        want = ref.bitmap_build_ref(tokens, lengths, b, method)
        runs = {f: (lambda f=f: bitmap_build.bitmap_build_cuda(tokens, lengths, b, method,
                                                               form=f))
                for f in ("lane", "warp")}
        runs |= {name: launcher(fn, tokens, lengths, b, method)
                 for name, (fn, _info) in built.items()}
        for name, run in runs.items():
            got = run()
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: {name} differs from the plain version")
        if args.check_only:
            print(f"{label}: every variant equals the plain version", flush=True)
            continue
        order = list(runs) + list(runs)[::-1]
        times = {name: [] for name in runs}
        for name in order:
            times[name].append(cuda_ms(runs[name], args.iters))
        summary["shapes"][label] = times
        print(f"{label} ({tokens.shape[0]} x {tokens.shape[1]}): "
              + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in times.items())
              + " ms", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
