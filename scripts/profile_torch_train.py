#!/usr/bin/env python3
"""Where the time of the port's LM training step goes, on one GPU, and how
wide the margin of ``chip_smoke.py``'s gradient gate is across seeds.

    PYTHONPATH=src python3 scripts/profile_torch_train.py [--seed N]
        [--grad-seeds 0,1,2] [--steps 20] [--reduced] [--device cpu]

Builds the training cell of ``chip_smoke.py`` (phase 12): smollm-135m at its
published widths and depth, float32 parameters drawn on the card from the
seed, bf16 compute, remat, ``SyntheticLMLoader`` batches of 8 x 2,048 tokens,
AdamW at chip_smoke's learning rate and warmup (``--reduced``: the reduced
config at 2 x 256 tokens, a quick check of the script).

1. The gradient gate, once for each of ``--grad-seeds``: one step's loss and
   gradients through the flash kernel against the same step with the plain
   forward, and the negative control (lse + log 2 on one head), each as the
   largest leaf's relative RMS error (chip_smoke's ``grad_gate``).
2. Steps 1-2 warm; steps 3 to ``--steps`` run with a synchronize after each:
   per step the host's wall time, the process's CPU time (all threads) and
   the device time between CUDA events around the step.
3. The same steps again under ``torch.profiler``: per step the device's busy
   time (the sum of its kernels) in the step's window and its kernels, and
   over all of them the busy time of the attention backward (its kernels by
   name: the profiler gives kernels launched through ``ctypes`` no parent
   op, so a scope's device time leaves them out), of the first forward and
   loss (``Model.loss``, less its flash kernels), of the clipping and
   optimizer update, of the flash forward kernel, and the largest kernels;
   the host time inside the backward's and the forward's scopes; the idle
   share against the profiled walls and against the walls of part 2.

Prints one JSON object a part.  At full size part 3 held about 7 million
profiler events with the plain backward on the card (before its kernel), and
reading them took minutes: allow the run 25 minutes on the GPU machine.  Runs on the card; ``--device cpu`` runs
the same logic with no device times (use it with ``--reduced``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def annotated(owner, name: str, label: str):
    """Wrap ``owner.name`` in a ``record_function(label)`` scope while inside."""
    from torch.profiler import record_function

    orig = getattr(owner, name)

    def wrapped(*args, **kwargs):
        with record_function(label):
            return orig(*args, **kwargs)

    setattr(owner, name, wrapped)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def grad_margins(cfg, opt_cfg, b: int, s: int, seeds: list[int], dev) -> list[dict]:
    """chip_smoke's gradient gate and its negative control on each seed."""
    from chip_smoke import GRAD_REL_TOL, flash_forward, grad_gate, loss_and_grads
    from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
    from repro_torch.models import Model
    from repro_torch.train import init_state

    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    rows = []
    for seed in seeds:
        model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
        init_state(model, opt_cfg)
        batch = next(SyntheticLMLoader(cfg, LoaderConfig(batch_size=b, seq_len=s, seed=seed,
                                                         vocab_size=cfg.vocab_size), device=dev))
        kernel = loss_and_grads(model, batch)
        with flash_forward("plain"):
            plain = loss_and_grads(model, batch)
        with flash_forward("shifted"):
            bad = loss_and_grads(model, batch)
        loss_err, worst, leaf, ok = grad_gate(kernel, plain, dtype)
        _, bad_worst, bad_leaf, bad_ok = grad_gate(bad, plain, dtype)
        rows.append({"seed": seed, "loss_rel_err": loss_err, "worst_leaf": leaf,
                     "worst_rel_rms": worst, "gate": GRAD_REL_TOL[dtype], "passes": ok,
                     "control_leaf": bad_leaf, "control_rel_rms": bad_worst,
                     "control_passes": bad_ok})
        del model, batch, kernel, plain, bad
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--grad-seeds", default="0,1,2")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--reduced", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import TRAIN
    from repro_torch import configs
    from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.train import OptimizerConfig, init_state, make_train_step
    from repro_torch.train import optimizer as opt_lib

    if cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if args.reduced:
        cfg, b, s = configs.get_reduced(TRAIN["arch"]), 2, 256
    else:
        cfg, b, s = configs.get(TRAIN["arch"]), TRAIN["batch"], TRAIN["seq"]
    opt_cfg = OptimizerConfig(learning_rate=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                              decay_steps=TRAIN["steps"])

    seeds = [int(x) for x in args.grad_seeds.split(",") if x]
    print(json.dumps({"part": "gradient gate", "arch": cfg.name, "batch": b, "seq": s,
                      "seeds": grad_margins(cfg, opt_cfg, b, s, seeds, dev)}), flush=True)

    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    state = init_state(model, opt_cfg)
    loader = SyntheticLMLoader(cfg, LoaderConfig(batch_size=b, seq_len=s, seed=args.seed,
                                                 vocab_size=cfg.vocab_size), device=dev)
    step = make_train_step(model, opt_cfg)
    for _ in range(2):
        state, _ = step(state, next(loader))
    sync()
    n = args.steps - 2

    # Part 2: steps 3..steps, no profiler.
    rows = []
    for _ in range(n):
        batch = next(loader)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 if cuda else 0)]
        c0, t0 = time.process_time(), time.perf_counter()
        if ev:
            ev[0].record()
        state, metrics = step(state, batch)
        if ev:
            ev[1].record()
        t_host = time.perf_counter() - t0
        sync()
        rows.append({"wall_ms": (time.perf_counter() - t0) * 1e3, "host_ms": t_host * 1e3,
                     "cpu_ms": (time.process_time() - c0) * 1e3,
                     "device_ms": ev[0].elapsed_time(ev[1]) if ev else float("nan"),
                     "loss": float(metrics["loss"])})
    walls = [r["wall_ms"] for r in rows]
    print(json.dumps({
        "part": "steps", "arch": cfg.name, "batch": b, "seq": s, "first_step": 3,
        "wall_ms_median": statistics.median(walls), "wall_ms_range": [min(walls), max(walls)],
        "device_ms_median": statistics.median(r["device_ms"] for r in rows),
        "cpu_over_wall": sum(r["cpu_ms"] for r in rows) / sum(walls),
        "wall_device_corr": float(np.corrcoef(walls, [r["device_ms"] for r in rows])[0, 1]),
        "wall_cpu_corr": float(np.corrcoef(walls, [r["cpu_ms"] for r in rows])[0, 1]),
        "rows": rows}), flush=True)

    # Part 3: the same number of steps under the profiler.
    labels = ("flash_bwd", "forward_loss", "optimizer", "train_step")
    with contextlib.ExitStack() as stack:
        stack.enter_context(annotated(ops, "flash_attention_bwd", "flash_bwd"))
        stack.enter_context(annotated(model, "loss", "forward_loss"))
        stack.enter_context(annotated(opt_lib, "clip_by_global_norm", "optimizer"))
        stack.enter_context(annotated(opt_lib, "opt_update", "optimizer"))
        prof = stack.enter_context(profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])))
        for _ in range(n):
            batch = next(loader)
            with record_function("train_step"):
                state, metrics = step(state, batch)
                sync()
    events = prof.events()
    # Device events, less the device-side copies of the scopes above.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in labels
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(k.device_time_total for k in kernels) or float("nan")
    # Kernels by start time against each step's scope: the profiler puts host
    # and device events on one time line (us); the scope ends after a sync.
    starts = np.array([k.time_range.start for k in kernels])
    durs = np.array([k.device_time_total for k in kernels])
    windows = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.name == "train_step" and e.device_type == DeviceType.CPU)
    per_step = []
    for t0, t1 in windows:
        sel = (starts >= t0) & (starts < t1)
        per_step.append({"wall_ms": (t1 - t0) / 1e3, "busy_ms": float(durs[sel].sum()) / 1e3,
                         "kernels": int(sel.sum())})

    def scoped_us(label: str, host: bool = False) -> float:
        return sum(e.cpu_time_total if host else e.device_time_total for e in events
                   if e.name == label and e.device_type == DeviceType.CPU)

    by_kernel: dict = {}
    for k in kernels:
        us, c = by_kernel.get(k.name, (0.0, 0))
        by_kernel[k.name] = (us + k.device_time_total, c + 1)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    fwd_kernel_us = sum(us for name, (us, _) in by_kernel.items() if "flash_fwd" in name)
    bwd_kernel_us = sum(us for name, (us, _) in by_kernel.items() if "flash_bwd" in name)
    fwd_us, opt_us = (scoped_us(x) for x in ("forward_loss", "optimizer"))
    wall_prof = sum(r["wall_ms"] for r in per_step) / 1e3
    busy = sum(r["busy_ms"] for r in per_step)
    print(json.dumps({
        "part": "profile", "arch": cfg.name, "batch": b, "seq": s, "steps": n,
        "wall_s": wall_prof, "wall_s_unprofiled": sum(walls) / 1e3,
        "device_busy_s": busy_us / 1e6, "busy_in_step_windows_s": busy / 1e3,
        "idle_share": 1.0 - busy_us / 1e6 / wall_prof,
        "idle_share_unprofiled_walls": 1.0 - busy_us / 1e3 / sum(walls),
        "busy_ms_a_step_median": statistics.median(r["busy_ms"] for r in per_step),
        "busy_ms_a_step_range": [min(r["busy_ms"] for r in per_step),
                                 max(r["busy_ms"] for r in per_step)],
        "flash_bwd_busy_s": bwd_kernel_us / 1e6,
        "flash_bwd_share_of_busy": bwd_kernel_us / busy_us,
        "flash_bwd_host_s": scoped_us("flash_bwd", host=True) / 1e6,
        "forward_loss_host_s": scoped_us("forward_loss", host=True) / 1e6,
        "forward_loss_busy_s": fwd_us / 1e6, "forward_loss_share_of_busy": fwd_us / busy_us,
        "optimizer_busy_s": opt_us / 1e6, "optimizer_share_of_busy": opt_us / busy_us,
        "rest_share_of_busy": 1.0 - (bwd_kernel_us + fwd_us + opt_us) / busy_us,
        "flash_fwd_kernel_busy_s": fwd_kernel_us / 1e6, "kernel_launches": len(kernels),
        "kernels_a_step_median": statistics.median(r["kernels"] for r in per_step),
        "cpu_ops": sum(1 for e in events if e.device_type == DeviceType.CPU),
        "per_step": per_step,
        "device_us_by_kernel": [{"kernel": k[:100], "us": us, "calls": c}
                                for k, (us, c) in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
