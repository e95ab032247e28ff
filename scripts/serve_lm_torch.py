#!/usr/bin/env python3
"""Serving example: prefill and batched greedy decode through the KV / SSM
cache, on the card (the PyTorch twin of the JAX package's
``examples/serve_lm.py``: the same prompts and lines; the weights are the
port's seeded ones, so the tokens differ).

    PYTHONPATH=src python scripts/serve_lm_torch.py [arch] [--device cpu]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 scripts/serve_lm_torch.py \\
        qwen3-8b --mesh 2x2 --device cpu

``--mesh DxM`` serves the token-input families (dense, moe, ssm, hybrid, vlm)
over a (data, model) mesh, one
process a rank (``torchrun``; gloo on the CPU, NCCL on the cards, one card a
rank): ``sharded_prefill`` and ``sharded_decode_step`` on each rank's
slices of the parameters and rows of the batch.  Rank 0 then checks its
tokens against the single-device engine's.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("arch", nargs="?", default="zamba2-7b",
                        help="hybrid by default: KV and SSM caches")
    parser.add_argument("--device", default=None, help="default: the card")
    parser.add_argument("--mesh", default=None, help="DxM: serve over a data x model mesh")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch

    from repro_torch import configs
    from repro_torch.core.engine import resolve_device
    from repro_torch.models import DecodeEngine, Model
    from repro_torch.models.generate import greedy_generate

    dev = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    engine = DecodeEngine(model)
    b, prompt_len, gen = 4, 24, 16
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, prompt_len))
                              .astype(np.int32)).to(dev)
    if args.mesh:
        return _serve_sharded(args, cfg, model, prompt, gen)
    extra = {}
    if cfg.family == "vlm":
        extra["image_embeds"] = torch.zeros((b, cfg.num_image_tokens, cfg.d_model), device=dev)
    if cfg.frame_inputs:
        prompt, extra["frame_embeds"] = None, torch.from_numpy(rng.normal(
            size=(b, prompt_len + gen - 1, cfg.d_model)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        out = greedy_generate(engine, prompt, gen, **extra)
    cache_keys = sorted(engine.init_cache(1, 1))
    print(f"{args.arch}: prefilled {prompt_len} tokens; cache keys: {cache_keys}")
    print(f"greedy-decoded {gen} tokens per sequence: {out.tokens[0][:10].cpu().numpy()}...")
    print("serve_step OK")
    return 0


def _serve_sharded(args, cfg, model, prompt, gen: int) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.sharding import activation_sharding, layout_of, shard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import DecodeEngine
    from repro_torch.models.generate import greedy_generate, sharded_greedy_generate
    from repro_torch.models.model import param_specs

    d, m = (int(x) for x in args.mesh.split("x"))
    if cfg.frame_inputs:
        raise SystemExit(f"{args.arch} takes frame embeddings a step: --mesh serves token models")
    if "RANK" not in os.environ:
        raise SystemExit(f"--mesh {args.mesh} runs {d * m} ranks: start it under torchrun "
                         f"--nproc-per-node {d * m}")
    on_card = prompt.device.type == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        prompt = prompt.to(f"cuda:{int(os.environ['LOCAL_RANK'])}")
        model = model.to(prompt.device)
    dist.init_process_group("nccl" if on_card else "gloo")
    try:
        mesh = make_mesh((d, m), ("data", "model"), device_type=prompt.device.type)
        layout = layout_of(mesh)
        specs = param_specs(cfg, mesh)
        params = shard_tree(model.param_tree(), specs, mesh)
        rows = prompt.shape[0] // d
        lo = layout.index(("data",)) * rows
        mine = prompt[lo:lo + rows]
        images = (torch.zeros((prompt.shape[0], cfg.num_image_tokens, cfg.d_model),
                              device=prompt.device) if cfg.family == "vlm" else None)
        with torch.inference_mode(), activation_sharding(mesh):
            out = sharded_greedy_generate(cfg, params, specs, mine, gen,
                                          image_embeds=None if images is None else
                                          images[lo:lo + rows])
        if dist.get_rank() == 0:
            extra = {} if images is None else {"image_embeds": images[:rows]}
            with torch.inference_mode():
                single = greedy_generate(DecodeEngine(model), prompt[:rows], gen, **extra)
            same = torch.equal(out.tokens, single.tokens)
            print(f"{args.arch} on a {d}x{m} mesh: prefilled {prompt.shape[1]} tokens, "
                  f"greedy-decoded {gen} tokens per sequence: "
                  f"{out.tokens[0][:10].cpu().numpy()}...")
            print(f"rank 0's tokens {'equal' if same else 'DIFFER FROM'} the single device's")
            if not same:
                return 1
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
