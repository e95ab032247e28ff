#!/usr/bin/env python3
"""Where the time of the port's LM serving path goes, on one GPU.

    PYTHONPATH=src python3 scripts/profile_torch_lm.py [--seed N] [--out DIR]

Builds the LM serving cell of ``chip_smoke.py`` — qwen3-8b at its published
widths and depth, f32 parameters drawn on the card from ``--seed``, bf16
compute, 4 prompts of 4,096 seeded tokens, a cache of 4,128 positions — and
warms it with one ``greedy_generate`` of 4 tokens.  Then, under
``torch.profiler``, one prefill (``last_only``) and 8 teacher-forced decode
steps from its cache, and prints for each: the wall time, the device's busy
time (the sum of the kernels that ran on it) and idle share, the device time
of the largest kernels and of the port's ``flash_attention`` kernel (time,
calls, mean per call).  The Chrome traces go to ``--out`` (default
``profile_traces/``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="profile_traces")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_lm: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import LM
    from repro_torch import configs
    from repro_torch.models import DecodeEngine, Model
    from repro_torch.models.generate import greedy_generate

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    cfg = configs.get(LM["arch"])
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    engine = DecodeEngine(model)
    b, p, n = LM["batch"], LM["prompt"], LM["gen"]
    rng = np.random.default_rng(args.seed + 70)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)).to(dev)
    warm = greedy_generate(engine, prompt, 4, max_len=p + n)    # builds the kernels
    steps = torch.cat([warm.tokens, warm.tokens], dim=1)        # 8 tokens to feed

    state = {}

    def prefill():
        state["cache"] = engine.prefill(model, {"tokens": prompt}, max_len=p + n,
                                    last_only=True)[1]

    def decode():
        for t in range(steps.shape[1]):
            engine.decode_step(model, state["cache"], {"tokens": steps[:, t:t + 1]})

    with torch.inference_mode():
        for name, run in (("prefill", prefill), ("decode x8", decode)):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            prof.export_chrome_trace(str(out / f"lm_{name.split()[0]}_trace.json"))
            # Device-side events only: each aten op is also listed on the host
            # side with the time of the kernels it launched.
            by_kernel = {ev.key: (ev.self_device_time_total, ev.count)
                         for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA}
            busy_us = sum(us for us, _ in by_kernel.values())
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
            own = [(k, us, c) for k, (us, c) in by_kernel.items() if "flash::" in k]
            print(json.dumps({
                "phase": name, "arch": cfg.name, "batch": b, "prompt": p,
                "wall_s": wall, "device_busy_s": busy_us / 1e6,
                "device_idle_share": 1.0 - busy_us / 1e6 / wall, "kernels": len(by_kernel),
                "device_us_by_kernel": [{"kernel": k[:100], "us": us, "calls": c}
                                        for k, (us, c) in top],
                "flash_attention": [{"kernel": k[:100], "us": us, "calls": c,
                                     "us_per_call": us / c} for k, us, c in own],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
