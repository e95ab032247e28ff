#!/usr/bin/env python3
"""Time this tree's bit-plane and flash-attention kernels against another
tree's, in one process on one GPU.

    PYTHONPATH=src python3 scripts/compare_kernels.py --baseline DIR [--seed N]

``DIR`` is another checkout of the repository, for example the parent
commit unpacked from ``git archive``.  Both trees' ``csrc/bitplane.cu`` and
``csrc/flash_attention.cu`` are compiled with this tree's ``nvcc`` flags
(each with its own headers) into ``kernels/.build/compare/`` and called
through their plain C entry points on the same inputs:

* ``bitplane_hamming`` at 4096 x 4096 and 4096 x 4097 (NS % 4 != 0),
  b = 1024, random {0, 1} planes: both trees must equal the plain version
  exactly;
* ``flash_attention``, bf16, causal, at qwen3-8b's layer shape (B = 4,
  S = 4,096, H = 32, KV = 8) with head dims 128 and 64, and at
  smollm-135m's (B = 8, S = 2,048, H = 9, KV = 3, D = 64): both trees
  within 1e-2 of the plain version.  Whether the two trees' outputs are
  bit-identical is printed, and so is whether the SASS of their wgmma
  kernels at those head dims (``cuobjdump -sass``, addresses and comments
  dropped) is;
* ``flash_attention_bwd``, bf16, causal, at qwen3-8b's layer (D = 128) and
  smollm-135m's: both trees' (dq, dk, dv) within 5% relative RMS of the
  plain backward, and whether they are bit-identical.

A tree whose entry points take a query offset is called with offset 0.

Each is timed as device time of back-to-back launches
(``chip_smoke.cuda_ms``) in turns, baseline, this tree, this tree,
baseline, beside the PyTorch yardsticks (``torch._int_mm``'s product alone,
``scaled_dot_product_attention``).  Prints the card's name and power
limit, one line per shape, and a JSON summary last.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
_C, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "bitplane": ("bitplane_hamming_launch", [_C, _C, _C, _C, _I, _I, _I, _C, _C]),
    "flash_attention": ("flash_attention_launch",
                        [_C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _C]),
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            [_C] * 10 + [_I] * 9 + [ctypes.c_float, _C]),
}
# A tree older than the float32 3xTF32 instance has no `scratch` argument
# after `o` (bf16 reads none), and one older than the lse output no `lse`
# after `scratch`: their entry points are called without them.
NO_SCRATCH = "void* o,\n                                      int batch"
NO_LSE = "const void* scratch, int batch"
# A tree older than the query offset has no `q_offset` after `causal` in the
# backward's entry point.
WITH_OFFSET = "int causal, int q_offset, float scale"


def build(trees: dict, out: Path) -> dict:
    """``{(tag, source): C function}`` for every tree and source, compiled in
    parallel; raises with the compiler's output on a failure."""
    import subprocess

    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)

    def one(key):
        tag, name = key
        lib = out / f"lib{tag}_{name}.so"
        src = trees[tag] / "src/repro_torch/kernels/csrc" / f"{name}.cu"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(lib)), fn_name)
        if name == "flash_attention" and NO_SCRATCH in src.read_text():
            fn.argtypes, fn.restype = argtypes[:4] + argtypes[6:], _I
            return key, lambda q, k, v, o, scratch, lse, *rest, fn=fn: fn(q, k, v, o, *rest)
        if name == "flash_attention" and NO_LSE in src.read_text():
            fn.argtypes, fn.restype = argtypes[:5] + argtypes[6:], _I
            return key, lambda q, k, v, o, scratch, lse, *rest, fn=fn: fn(q, k, v, o, scratch,
                                                                          *rest)
        if name == "flash_attention_bwd":
            if WITH_OFFSET in src.read_text():
                fn.argtypes, fn.restype = argtypes, _I
                return key, lambda *a, fn=fn: fn(*a[:18], 0, *a[18:])
            fn.argtypes, fn.restype = argtypes[:18] + argtypes[19:], _I
            return key, fn
        fn.argtypes, fn.restype = argtypes, _I
        return key, fn

    keys = [(tag, name) for tag in trees for name in SIGNATURES]
    with ThreadPoolExecutor(max_workers=len(keys)) as pool:
        return dict(pool.map(one, keys))


def wgmma_sass(lib: Path, d: int):
    """The SASS of ``flash_fwd_wgmma_kernel<d>`` (without lse) in ``lib`` as a list of
    instructions (addresses, encodings and comments dropped), or None when
    ``cuobjdump`` is not found."""
    import re
    import shutil
    import subprocess

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    # A tree with the lse output has two instances a head dim; the one
    # without lse (``Lb0``) is the one the baseline's kernel compares with.
    blocks = text.split("Function : ")[1:]
    for name in (f"flash_fwd_wgmma_kernelILi{d}ELb0E", f"flash_fwd_wgmma_kernelILi{d}E"):
        for block in blocks:
            if name in block.split("\n", 1)[0]:
                return [re.sub(r"\s+", " ", m.group(1)).strip()
                        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", block)]
    raise RuntimeError(f"{lib} has no flash_fwd_wgmma_kernel<{d}>")


# (name, B, S, H, KV, D) of the forward's comparisons; the backward's at the
# (name, D) of BWD_LAYERS.
FLASH_LAYERS = [("qwen3-8b", 4, 4096, 32, 8, 128), ("qwen3-8b", 4, 4096, 32, 8, 64),
                ("smollm-135m", 8, 2048, 9, 3, 64)]
BWD_LAYERS = {("qwen3-8b", 128), ("smollm-135m", 64)}


def compare_bwd(fns, trees, q, k, v, out, name, stream) -> dict:
    """Both trees' backward kernels on one layer's causal bf16 operands,
    held to the plain backward (relative RMS 5%) and timed in turns."""
    from chip_smoke import cuda_ms
    from repro_torch.kernels import flash_attention as flash_kernel, ref

    b, s, h, d = q.shape
    kvh = k.shape[2]
    do = torch.randn_like(q)
    _, lse = flash_kernel.flash_attention_cuda(q, k, v, return_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, triangle=True)
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    runs, grads, rel = {}, {}, {}
    for tag in trees:
        g = grads[tag] = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        fn = fns[(tag, "flash_attention_bwd")]
        runs[tag] = lambda fn=fn, g=g: checked(fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            do.data_ptr(), g[0].data_ptr(), g[1].data_ptr(), g[2].data_ptr(), dsum.data_ptr(),
            b, s, s, h, kvh, d, 1, 1, d ** -0.5, stream()), "flash_attention_bwd")
        runs[tag]()
        rel[tag] = max(float((x.double() - w.double()).norm() / w.double().norm())
                       for x, w in zip(g, want))
    if max(rel.values()) > 0.05:
        raise AssertionError(f"flash_attention_bwd {name} D={d}: relative RMS {rel}")
    same = all(torch.equal(a, c) for a, c in zip(grads["baseline"], grads["this"]))
    times = {tag: [] for tag in trees}
    for tag in ("baseline", "this", "this", "baseline"):
        times[tag].append(cuda_ms(runs[tag], 10))
    print(f"flash_attention_bwd {name} B={b} S={s} H={h} KV={kvh} D={d} bf16 causal, device ms "
          f"in turns: baseline {times['baseline']}, this tree {times['this']}; relative RMS "
          f"against the plain backward {rel}; gradients bit-identical: {same}", flush=True)
    return {"ms": times, "rel_rms": rel, "grads_identical": same}


def checked(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", required=True, type=Path)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from chip_smoke import FLASH_TOL, cuda_ms, max_err, max_err_float, smi_line
    from repro_torch.kernels import _build, ref

    print(smi_line(), flush=True)
    trees = {"baseline": args.baseline.resolve(), "this": ROOT}
    fns = build(trees, _build.BUILD_ROOT / "compare")
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    summary = {"device": torch.cuda.get_device_name(0), "baseline": str(args.baseline)}

    b = 1024
    for nr, ns in ((4096, 4096), (4096, 4097)):
        pr = torch.randint(0, 2, (nr, b), generator=gen, device=dev, dtype=torch.int8)
        ps = torch.randint(0, 2, (ns, b), generator=gen, device=dev, dtype=torch.int8)
        pc_r, pc_s = pr.sum(1, dtype=torch.int32), ps.sum(1, dtype=torch.int32)
        want = ref.bitplane_hamming_ref(pr, ps, pc_r, pc_s)
        outs, runs = {}, {}
        for tag in trees:
            out = torch.empty((nr, ns), dtype=torch.int32, device=dev)
            fn = fns[(tag, "bitplane")]
            runs[tag] = lambda fn=fn, out=out: checked(fn(
                pr.data_ptr(), ps.data_ptr(), pc_r.data_ptr(), pc_s.data_ptr(), nr, ns, b,
                out.data_ptr(), stream()), "bitplane_hamming")
            runs[tag]()
            outs[tag] = out
        errs = {tag: max_err(out, want) for tag, out in outs.items()}
        if any(errs.values()):
            raise AssertionError(f"bitplane_hamming {nr}x{ns}: errors {errs}")
        times = {tag: [] for tag in trees}
        for tag in ("baseline", "this", "this", "baseline"):
            times[tag].append(cuda_ms(runs[tag], 50))
        mm = cuda_ms(lambda: torch._int_mm(pr, ps.T), 50) if ns % 8 == 0 else None
        print(f"bitplane_hamming {nr}x{ns} b={b}, device ms in turns: baseline "
              f"{times['baseline']}, this tree {times['this']}; torch._int_mm product alone "
              f"{mm}; both exact", flush=True)
        summary[f"bitplane_hamming_{nr}x{ns}"] = {"ms": times, "int_mm_ms": mm}

    out_dir = _build.BUILD_ROOT / "compare"
    for name, bsz, seq, h, kvh, d in FLASH_LAYERS:
        q = torch.randn((bsz, seq, h, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((bsz, seq, kvh, d), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        want = ref.flash_attention_ref(q, k, v, causal=True, triangle=True)
        runs, errs, outs = {}, {}, {}
        for tag in trees:
            out = outs[tag] = torch.empty_like(q)
            fn = fns[(tag, "flash_attention")]
            runs[tag] = lambda fn=fn, out=out: checked(fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, None, bsz, seq,
                seq, h, kvh, d, 1, 1, d ** -0.5, stream()), "flash_attention")
            runs[tag]()
            errs[tag] = max_err_float(out, want)
        if not all(np.isfinite(list(errs.values()))) or max(errs.values()) > FLASH_TOL[q.dtype]:
            raise AssertionError(f"flash_attention {name} D={d} against its plain version: "
                                 f"{errs}")
        del want
        same_out = torch.equal(outs["baseline"], outs["this"])
        times = {tag: [] for tag in trees}
        for tag in ("baseline", "this", "this", "baseline"):
            times[tag].append(cuda_ms(runs[tag], 20))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              enable_gqa=True), 20)
        sass = {tag: wgmma_sass(out_dir / f"lib{tag}_flash_attention.so", d) for tag in trees}
        same = None if None in sass.values() else sass["baseline"] == sass["this"]
        changed = None if same is None else sum(
            line[:1] in "+-" and line[:3] not in ("+++", "---")
            for line in difflib.unified_diff(sass["baseline"], sass["this"], lineterm=""))
        print(f"flash_attention {name} B={bsz} S={seq} H={h} KV={kvh} D={d} bf16 causal, "
              f"device ms in turns: "
              f"baseline {times['baseline']}, this tree {times['this']}; "
              f"scaled_dot_product_attention {sdpa}; max |err| against the plain version "
              f"{errs}; outputs bit-identical: {same_out}; wgmma kernel SASS identical: {same} (instructions: "
              f"{ {tag: None if x is None else len(x) for tag, x in sass.items()} }, "
              f"lines added or removed: {changed})",
              flush=True)
        summary[f"flash_attention_{name}_d{d}"] = {
            "ms": times, "sdpa_ms": sdpa, "max_abs_err": errs, "outputs_identical": same_out,
            "sass_identical": same, "sass_lines_changed": changed}
        if (name, d) in BWD_LAYERS:
            summary[f"flash_attention_bwd_{name}_d{d}"] = compare_bwd(
                fns, trees, q, k, v, outs["this"], name, stream)
        del q, k, v, runs, outs
    print(smi_line())
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
