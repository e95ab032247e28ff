#!/usr/bin/env python3
"""End-to-end driver: train a (reduced) assigned architecture for a few
hundred steps on the card with the port's training substrate (synthetic
loader, the train step, async checkpoints, the fault-tolerant runner); the
PyTorch twin of the JAX package's ``examples/train_lm.py``.

    PYTHONPATH=src python scripts/train_lm_torch.py [--arch qwen3-8b] [--device cpu]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 scripts/train_lm_torch.py \\
        --mesh 2x2 --device cpu

Any of the 10 assigned archs work through ``--arch`` (sharded over
``--mesh``: the dense, moe, vlm and audio families); the arguments go on to
``repro_torch.launch.train``, whose ``--help`` lists them.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.launch.train import train_main

    args = list(sys.argv[1:] if argv is None else argv)
    if not any(a == "--arch" or a.startswith("--arch=") for a in args):
        args += ["--arch", "smollm-135m"]
    train_main(args + [
        "--reduced", "--steps", "300", "--batch", "8", "--seq", "64",
        "--ckpt-every", "100",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt"),
        "--log-every", "25", "--lr", "3e-3",
    ])
    return 0


if __name__ == "__main__":
    sys.exit(main())
