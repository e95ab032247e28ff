#!/usr/bin/env python3
"""The flash-attention kernel's small-head-dim shapes, built side by side
and timed in turns on one GPU.

    PYTHONPATH=src python3 scripts/flash_variants.py [--variants NAME ...]
        [--check-only] [--breakdown] [--seed N]

The wgmma instance's shape at head dims 16 and 32 is fixed at compile time
by ``wg::Cfg`` in ``src/repro_torch/kernels/csrc/flash_attention.cu``.
This script writes one copy of that source per variant with ``Cfg``'s
lines for head dims below 64 replaced (``VARIANTS``: K/V ring stages,
whether the consumers take turns issuing their products, keys per K/V tile,
blocks per SM, chains of the row maximum), compiles each with the port's
``nvcc`` flags, all in parallel, and prints each one's registers and
spills; then, at head dims 32 and 16, bf16, causal:

1. holds every variant within 1e-2 of the plain version
   (``ref.flash_attention_ref``) on ragged shapes (Sq, Sk on the 128-row
   and 192-row tile edges, groups 1, 3, 4 and 8, causal and not) and at the
   layer shape B = 4, S = 4,096, H = 32, KV = 8;
2. unless ``--check-only``, times the variants at the layer shape as device
   time (``chip_smoke.cuda_ms``) in turns: the shipped shape (``default``,
   the baseline), each other variant, then the same in reverse, beside
   ``scaled_dot_product_attention`` (``enable_gqa=True``), the yardstick the
   port never calls, with the SM clock (``nvidia-smi``, sampled every 0.1 s)
   while they run.

With ``--breakdown`` it builds the source's own shape instead with one
part of the work taken out (``BREAKDOWN``: the exponentials, the row
maxima, the row sums, the bf16 rounding of P, the P V product, the q K
product, or several), and times each at the layer shape in turns with the
whole kernel.  Those variants compute wrong answers by design; only their
device times are printed.

Prints the card's name and power limit, a line per head dim, and a JSON
summary last.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def small_d_shape(stages: int, turns: bool, block_n: int, blocks_per_sm: int,
                  chains: int) -> list:
    """``Cfg``'s lines with the head dims below 64 set to one shape (the
    same at 16 and 32); 64 and 128 keep theirs."""
    return [
        ("kStages = D == 16 ? 4 : D == 32 ? 6 : D == 64 ? 4 : 3;",
         f"kStages = D < 64 ? {stages} : D == 64 ? 4 : 3;"),
        ("kTurns = kSmall;", f"kTurns = kSmall && {str(turns).lower()};"),
        ("kBlockN = D == 16 ? 64 : 128;", f"kBlockN = D < 64 ? {block_n} : 128;"),
        ("kBlocksPerSM = D == 16 ? 2 : 1;", f"kBlocksPerSM = D < 64 ? {blocks_per_sm} : 1;"),
        ("kMaxChains = kSmall ? 4 : 1;", f"kMaxChains = kSmall ? {chains} : 1;"),
    ]


# name: (ring stages, turns at the product issue, keys per K/V tile, blocks
# per SM, chains of the row maximum), each set for both head dims;
# "default" is the source's own shape for each head dim.
VARIANTS = {
    "default": None,
    "n128": (6, True, 128, 1, 4),
    "n64x2": (4, True, 64, 2, 4),
    "n128-m1": (6, True, 128, 1, 1),
    "n128-t0": (6, False, 128, 1, 4),
    "n128-s4": (4, True, 128, 1, 4),
    "n128-s8": (8, True, 128, 1, 4),
    "n64x2-t0": (4, False, 64, 2, 4),
    "n64x2-s8": (8, True, 64, 2, 4),
}
# Each part replaces lines of the source; a variant takes out its parts.
PARTS = {
    "exp": [("      x = ex2(fmaf(x, scale_log2, neg_ms[e >> 1]));",
             "      x = fmaf(x, scale_log2, neg_ms[e >> 1]);")],
    "max": [("      chain[e >> 1][j % kChains] = fmaxf(chain[e >> 1][j % kChains], "
             "sacc[4 * j + e]);", "      {}")],
    "sum": [("      rs[e >> 1] += x;\n", "")],
    "cvt": [("  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
             "  return *reinterpret_cast<const uint32_t*>(&v);",
             "  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);")],
    "pv": [("    if constexpr (C::kPad == 128)\n      wgmma_m64n128k16_rs_tb(oacc, pa[kk], desc, 1);",
            "    if constexpr (D < 64) {\n    } else if constexpr (C::kPad == 128)\n"
            "      wgmma_m64n128k16_rs_tb(oacc, pa[kk], desc, 1);")],
    "qk": [("  for (int kk = 0; kk < D / 16; ++kk) {\n    const uint32_t off",
            "  for (int kk = 0; kk < (D < 64 ? 0 : D / 16); ++kk) {\n    const uint32_t off")],
}
BREAKDOWN = {"no exp": ("exp",), "no max": ("max",), "no sum": ("sum",),
             "no cvt": ("cvt",), "no PV": ("pv",), "no QK": ("qk",),
             "no products": ("pv", "qk"), "no softmax": ("exp", "max", "sum", "cvt")}
C, I = ctypes.c_void_p, ctypes.c_int
WGMMA = 0   # the bf16 wgmma instance's code in flash_attention_launch_instance


def build_variant(name: str, out: Path):
    """One variant's ``flash_attention_launch_instance`` and its ptxas lines
    for the small-head-dim wgmma kernels: a shape of ``VARIANTS``, or the
    source's own shape with the parts of ``BREAKDOWN[name]`` taken out."""
    from repro_torch.kernels import _build

    lib = out / f"libflash_{name.replace(' ', '_')}.so"
    src = _build.CSRC / "flash_attention.cu"
    if name in BREAKDOWN:
        patches = [patch for part in BREAKDOWN[name] for patch in PARTS[part]]
    else:
        patches = small_d_shape(*VARIANTS[name]) if VARIANTS[name] else []
    if patches:
        # A patch applies to the kernel's source or to the Hopper header it
        # includes, whichever holds its text (once, in the two together).
        # Both patched copies go into the variant's own directory, where the
        # source's quoted #include "hopper.cuh" finds the header before -I.
        texts = {f: (_build.CSRC / f).read_text() for f in ("flash_attention.cu", "hopper.cuh")}
        for old, new in patches:
            where = [f for f, text in texts.items() if text.count(old)]
            if sum(texts[f].count(old) for f in where) != 1:
                raise RuntimeError(f"{name}: the sources no longer have {old!r} once")
            texts[where[0]] = texts[where[0]].replace(old, new)
        vdir = out / f"flash_{name.replace(' ', '_')}"
        vdir.mkdir(parents=True, exist_ok=True)
        for f, text in texts.items():
            (vdir / f).write_text(text)
        src = vdir / "flash_attention.cu"
    flags = [f"-I{_build.CSRC}"]
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).flash_attention_launch_instance
    fn.argtypes = [C, C, C, C, C, C, I, I, I, I, I, I, I, I, I, ctypes.c_float, I, C]
    fn.restype = I
    lines, keep = [], False
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            # The instances without lse (Lb0), the ones the variants run.
            keep = ("flash_fwd_wgmma_kernelILi16ELb0" in line
                    or "flash_fwd_wgmma_kernelILi32ELb0" in line)
            if keep:
                lines.append("D=16" if "ILi16" in line else "D=32")
        elif keep and any(w in line for w in ("registers", "spill", "warning", "serializ")):
            lines.append(line.split("info    :")[-1].strip())
    return fn, "; ".join(lines)


class ClockSampler:
    """The SM clock in MHz (``nvidia-smi --query-gpu=clocks.sm``) every 0.1 s
    while the ``with`` block runs."""

    def __enter__(self):
        self.samples, self.stop = [], threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()
        return self

    def run(self):
        while not self.stop.wait(0.1):
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits", "-i", "0"],
                                 capture_output=True, text=True, timeout=30)
            if out.returncode == 0:
                self.samples.append(float(out.stdout.strip()))

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()


def runner(fn, q, k, v, out, causal: bool = True):
    b, sq, h, d = q.shape

    def run():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, None, b, sq,
                k.shape[1], h, k.shape[2], d, 1, int(causal), 0, d ** -0.5, WGMMA,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash_attention launch: CUDA error {rc}")
    return run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    parser.add_argument("--check-only", action="store_true")
    parser.add_argument("--breakdown", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from chip_smoke import cuda_ms, flash_close, smi_line
    from repro_torch.kernels import _build, ref

    print(smi_line(), flush=True)
    out = _build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    # The shipped shape is always built: it is the baseline of the turns.
    names = ["default", *(BREAKDOWN if args.breakdown else
                          [n for n in args.variants if n != "default"])]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: build_variant(n, out), names)))
    for name, (_, info) in built.items():
        print(f"{name} {VARIANTS.get(name, BREAKDOWN.get(name))}: {info}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    summary = {"device": torch.cuda.get_device_name(0), "variants": VARIANTS}
    ragged = [  # sq, sk, group, KV, causal
        (1, 1, 1, 2, True), (127, 127, 1, 2, True), (129, 129, 4, 2, True),
        (191, 193, 3, 1, True), (255, 257, 8, 1, True), (257, 255, 1, 2, False),
        (385, 385, 4, 1, True), (193, 64, 3, 2, True), (100, 37, 8, 2, False),
        (1000, 1000, 8, 1, True)]
    for d in (32, 16):
        for sq, sk, g, kv, causal in ragged:
            q, k, v = (torch.randn((2, n, heads, d), generator=gen, device=dev)
                       .to(torch.bfloat16) for n, heads in ((sq, g * kv), (sk, kv), (sk, kv)))
            want = ref.flash_attention_ref(q, k, v, causal=causal, triangle=causal)
            for name, (fn, _) in built.items():
                if name in BREAKDOWN:
                    continue
                got = torch.empty_like(q)
                runner(fn, q, k, v, got, causal)()
                flash_close(got, want, f"{name} D={d} Sq={sq} Sk={sk} H={g * kv} KV={kv} "
                                       f"causal={causal}")
        q, k, v = (torch.randn((4, 4096, heads, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for heads in (32, 8, 8))
        want = ref.flash_attention_ref(q, k, v, causal=True, triangle=True)
        runs, errs = {}, {}
        for name, (fn, _) in built.items():
            got = torch.empty_like(q)
            runs[name] = runner(fn, q, k, v, got)
            runs[name]()
            if name not in BREAKDOWN:
                errs[name] = flash_close(got, want, f"{name} D={d} B=4 S=4096 H=32 KV=8")
        torch.cuda.synchronize()
        print(f"D={d}: every variant within 1e-2 of the plain version on {len(ragged)} ragged "
              f"shapes and at B=4 S=4096 H=32 KV=8; max |err| {errs}", flush=True)
        if args.check_only:
            continue
        order = list(runs) + list(runs)[::-1]
        times = {name: [] for name in runs}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        with ClockSampler() as clock:
            for name in order:
                times[name].append(cuda_ms(runs[name], 20))
            sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                  enable_gqa=True), 20)
        mhz = statistics.median(clock.samples) if clock.samples else None
        print(f"D={d} B=4 S=4096 H=32 KV=8 bf16 causal, device ms in turns: " +
              ", ".join(f"{n} {t[0]:.4f} / {t[1]:.4f}" for n, t in times.items()) +
              f"; scaled_dot_product_attention {sdpa:.4f}; SM clock median {mhz} MHz over "
              f"{len(clock.samples)} samples (min {min(clock.samples, default=None)})",
              flush=True)
        summary[f"D{d}"] = {"ms_turns": times, "sdpa_ms": sdpa, "max_abs_err": errs,
                            "sm_clock_mhz_median": mhz}
        del q, k, v, want, runs
    print(smi_line())
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
