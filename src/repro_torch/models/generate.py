"""Greedy generation through the KV cache: the loop of ``examples/serve_lm.py``.

    python -m repro_torch.models.generate [arch] [--full] [--device cpu]

Prefill of 4 seeded prompts of 24 tokens, argmax, then 15 one-token decode
steps, as the example runs them.  The reduced config of ``arch`` (default
qwen3-8b) runs unless ``--full`` asks for the published one; it runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.decode import DecodeEngine


@dataclasses.dataclass
class Generation:
    """What :func:`greedy_generate` returns."""
    tokens: torch.Tensor               # (B, gen) int32, the greedy picks
    logits: List[torch.Tensor]         # (B, V) each: the prefill's last position, then each step's
    prefill_s: float                   # host clock around the prefill and its argmax
    decode_s: float                    # host clock around the gen - 1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def greedy_generate(engine: DecodeEngine, tokens: torch.Tensor, gen: int, *,
                    max_len: Optional[int] = None) -> Generation:
    """Greedy-decode ``gen`` tokens after the prompt ``tokens`` (B, P): prefill,
    argmax, then ``gen - 1`` decode steps.  The cache is allocated at
    ``max_len`` (default P + gen).  Both phases are timed on the host clock,
    each ending in a device synchronise."""
    model = engine.model
    b, p = tokens.shape
    _sync(tokens.device)
    t0 = time.perf_counter()
    logits, cache = engine.prefill(model, {"tokens": tokens}, max_len=max_len or p + gen,
                                   last_only=True)
    step_logits = [logits[:, -1]]
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    _sync(tokens.device)
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = engine.decode_step(model, cache, {"tokens": tok})
        step_logits.append(logits[:, -1])
        tok = logits.argmax(dim=-1).to(torch.int32)
        out.append(tok)
    _sync(tokens.device)
    return Generation(torch.cat(out, dim=1), step_logits, t1 - t0, time.perf_counter() - t1)


def main(argv=None) -> int:
    from repro_torch import configs
    from repro_torch.core.engine import resolve_device
    from repro_torch.models.model import Model

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("arch", nargs="?", default="qwen3-8b", choices=configs.ARCHS)
    parser.add_argument("--full", action="store_true", help="the published config")
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch) if args.full else configs.get_reduced(args.arch)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    b, p, gen = 4, 24, 16
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, p)).astype(np.int32)).to(dev)
    out = greedy_generate(DecodeEngine(model), prompt, gen)
    print(f"{cfg.name} on {dev}: {model.num_params():,} parameters; prefilled {p} tokens x "
          f"{b} in {out.prefill_s:.3f} s ({b * p / out.prefill_s:.1f} tokens/s), greedy-"
          f"decoded {gen} tokens per sequence ({gen - 1} steps in {out.decode_s:.3f} s, "
          f"{b * (gen - 1) / out.decode_s:.1f} tokens/s): {out.tokens[0, :10].tolist()}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
