"""End-to-end training driver of the port, the twin of ``repro.launch.train``.

Runs a training loop with the port's substrate: the synthetic loader, the
train step (the flash kernel forward and its backward), checkpoints every
``--ckpt-every`` steps and the fault-tolerant runner.  It runs on the card
unless ``--device`` names another device; without a card and without
``--device`` it raises.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch smollm-135m --reduced --steps 100 --batch 4 --seq 32

Only the ``1x1`` mesh runs: meshes wait for multi-GPU (ROADMAP Queue 1
item 11).
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

from repro_torch import configs
from repro_torch.core.engine import resolve_device
from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
from repro_torch.distributed import CheckpointManager, FaultTolerantRunner, RunnerConfig
from repro_torch.models import Model
from repro_torch.train import OptimizerConfig
from repro_torch.train import step as step_lib

log = logging.getLogger("repro_torch.train")
MOE_METRICS = ("moe_aux_loss", "moe_z_loss", "moe_dropped")   # the moe family's aux


def train_main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="use the tiny same-family smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="1x1", help="DxM mesh; only 1x1 runs")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises without one)")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise SystemExit(f"mesh {args.mesh}: the port trains on one device; meshes wait for "
                         f"multi-GPU (ROADMAP Queue 1 item 11)")
    dev = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    model = Model(cfg, device=dev)
    opt_cfg = OptimizerConfig(name=args.optimizer, learning_rate=args.lr,
                              warmup_steps=max(args.steps // 20, 5),
                              decay_steps=args.steps)
    loader = SyntheticLMLoader(
        cfg, LoaderConfig(batch_size=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size),
        device=dev)
    ckpt = CheckpointManager(args.ckpt_dir)

    def make_state(_mesh_unused):
        return step_lib.init_state(model, opt_cfg), None

    step_raw = step_lib.make_train_step(model, opt_cfg, microbatches=args.microbatches)
    history = []

    def step_fn(state, batch):
        state, metrics = step_raw(state, batch)
        s = int(state["step"])
        if s % args.log_every == 0 or s == 1:
            m_host = {k: float(v) for k, v in metrics.items()}
            history.append((s, m_host))
            log.info("step %d: %s", s, {k: round(v, 4) for k, v in m_host.items()})
            moe = "".join(f" {k}={m_host[k]:.4f}" for k in MOE_METRICS if k in m_host)
            print(f"step {s}: loss={m_host['loss']:.4f} "
                  f"gnorm={m_host['grad_norm']:.3f} lr={m_host['lr']:.2e}{moe}", flush=True)
        return state, metrics

    runner = FaultTolerantRunner(step_fn, make_state, iter(loader), ckpt,
                                 RunnerConfig(checkpoint_every=args.ckpt_every))
    t0 = time.time()
    out = runner.run(args.steps)
    dt = time.time() - t0
    final_loss = history[-1][1]["loss"] if history else float("nan")
    print(f"trained {args.steps} steps in {dt:.1f}s; final loss {final_loss:.4f}; "
          f"restarts={out['restarts']}")
    return out, history


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    train_main()
