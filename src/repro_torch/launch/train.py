"""End-to-end training driver of the port, the twin of ``repro.launch.train``.

Runs a training loop with the port's substrate: the synthetic loader, the
train step (the flash kernel forward and its backward), checkpoints every
``--ckpt-every`` steps and the fault-tolerant runner.  It runs on the card
unless ``--device`` names another device; without a card and without
``--device`` it raises.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch smollm-135m --reduced --steps 100 --batch 4 --seq 32

``--mesh DxM`` trains sharded over a ``("data", "model")`` mesh of D x M
ranks (FSDP over ``data``, tensor parallel over ``model``; every
family), one process a rank under ``torchrun``: gloo on the CPU, NCCL on
the card with one GPU a rank (``LOCAL_RANK``; ``make_mesh`` refuses more
ranks than cards).  Under ``torchrun`` a ``1x1`` mesh takes the sharded
path too; rank 0 prints.

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --device cpu --mesh 2x2 --arch smollm-135m --reduced --steps 20
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.engine import resolve_device
from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
from repro_torch.distributed import CheckpointManager, FaultTolerantRunner, RunnerConfig
from repro_torch.distributed.sharding import named
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.train import OptimizerConfig
from repro_torch.train import step as step_lib

log = logging.getLogger("repro_torch.train")
MOE_METRICS = ("moe_aux_loss", "moe_z_loss", "moe_dropped")   # the moe family's aux
FSDP = ("data",)                  # the mesh's batch (FSDP) axis
COLLECTIVE_TIMEOUT_S = 600        # a rank that stops fails its peers' collectives


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
    ap.add_argument("--mesh", default="1x1",
                    help="DxM (data x model) mesh; more than one rank runs under torchrun")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises without one)")
    args = ap.parse_args(argv)

    d, m = (int(x) for x in args.mesh.split("x"))
    sharded = "RANK" in os.environ
    if d * m > 1 and not sharded:
        raise SystemExit(f"mesh {args.mesh} needs {d * m} ranks: run it under torchrun "
                         f"--nproc-per-node {d * m} (one process a rank)")
    dev = resolve_device(args.device)
    mesh = None
    if sharded:
        if int(os.environ["WORLD_SIZE"]) != d * m:
            raise SystemExit(f"mesh {args.mesh} needs {d * m} ranks; torchrun started "
                             f"{os.environ['WORLD_SIZE']}")
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", 0))
            if local < torch.cuda.device_count():
                dev = torch.device("cuda", local)
                torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        mesh = make_mesh((d, m), ("data", "model"), device_type=dev.type)
    lead = not sharded or dist.get_rank() == 0
    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    model = Model(cfg, device=dev)
    opt_cfg = OptimizerConfig(name=args.optimizer, learning_rate=args.lr,
                              warmup_steps=max(args.steps // 20, 5),
                              decay_steps=args.steps)
    loader = SyntheticLMLoader(
        cfg, LoaderConfig(batch_size=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size),
        device=dev, mesh=mesh, batch_axes=FSDP)
    ckpt = CheckpointManager(args.ckpt_dir)

    if mesh is None:
        def make_state(_mesh_unused):
            return step_lib.init_state(model, opt_cfg), None

        step_raw = step_lib.make_train_step(model, opt_cfg, microbatches=args.microbatches)
    else:
        step_raw, sspecs, _ = step_lib.sharded_train_step(
            model, opt_cfg, mesh, microbatches=args.microbatches, fsdp=FSDP)

        def make_state(_mesh_unused):
            return (step_lib.sharded_state(model, opt_cfg, mesh, fsdp=FSDP),
                    named(mesh, sspecs))
    history = []

    def step_fn(state, batch):
        state, metrics = step_raw(state, batch)
        s = int(state["step"])
        if s % args.log_every == 0 or s == 1:
            m_host = {k: float(v) for k, v in metrics.items()}
            history.append((s, m_host))
            moe = "".join(f" {k}={m_host[k]:.4f}" for k in MOE_METRICS if k in m_host)
            if lead:
                log.info("step %d: %s", s, {k: round(v, 4) for k, v in m_host.items()})
                print(f"step {s}: loss={m_host['loss']:.4f} "
                      f"gnorm={m_host['grad_norm']:.3f} lr={m_host['lr']:.2e}{moe}", flush=True)
        return state, metrics

    runner = FaultTolerantRunner(step_fn, make_state, iter(loader), ckpt,
                                 RunnerConfig(checkpoint_every=args.ckpt_every))
    t0 = time.time()
    out = runner.run(args.steps)
    dt = time.time() - t0
    final_loss = history[-1][1]["loss"] if history else float("nan")
    if lead:
        print(f"trained {args.steps} steps in {dt:.1f}s; final loss {final_loss:.4f}; "
              f"restarts={out['restarts']}" + (f"; mesh {args.mesh}" if mesh is not None else ""))
    if sharded:
        dist.destroy_process_group()
    return out, history


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    train_main()
