"""Greedy generation through the KV cache: the loop of ``examples/serve_lm.py``.

    python -m repro_torch.models.generate [arch] [--full] [--device cpu]

Prefill of 4 seeded prompts of 24 tokens, argmax, then 15 one-token decode
steps, as the example runs them: a vlm model also takes seeded image
embeddings, and a frame-input model (musicgen) takes 24 seeded prompt frames
and one seeded frame a decode step in place of the tokens, and returns the
argmax codes.  The reduced config of ``arch`` (default qwen3-8b) runs unless
``--full`` asks for the published one; it runs on the card unless
``--device cpu``.
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
def greedy_generate(engine: DecodeEngine, tokens: Optional[torch.Tensor], gen: int, *,
                    max_len: Optional[int] = None, image_embeds: Optional[torch.Tensor] = None,
                    frame_embeds: Optional[torch.Tensor] = None) -> Generation:
    """Greedy-decode ``gen`` tokens after the prompt ``tokens`` (B, P): prefill,
    argmax, then ``gen - 1`` decode steps, each fed the last pick.  A vlm
    model takes ``image_embeds`` (B, n_img, d) with the prompt.  A
    frame-input model takes ``frame_embeds`` (B, P + gen - 1, d) in place of
    ``tokens`` (pass None): the prompt's P frames, then one frame a decode
    step; its picks are the argmax codes.  The cache is allocated at
    ``max_len`` (default P + gen).  Both phases are timed on the host clock,
    each ending in a device synchronise."""
    model = engine.model
    if frame_embeds is not None:
        b, p = frame_embeds.shape[0], frame_embeds.shape[1] - (gen - 1)
        batch = {"frame_embeds": frame_embeds[:, :p]}
    else:
        (b, p), batch = tokens.shape, {"tokens": tokens}
    if image_embeds is not None:
        batch["image_embeds"] = image_embeds
    device = next(iter(batch.values())).device
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = engine.prefill(model, batch, max_len=max_len or p + gen, last_only=True)
    step_logits = [logits[:, -1]]
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    out = [tok]
    for t in range(gen - 1):
        step = ({"frame_embeds": frame_embeds[:, p + t:p + t + 1]} if frame_embeds is not None
                else {"tokens": tok})
        logits, cache = engine.decode_step(model, cache, step)
        step_logits.append(logits[:, -1])
        tok = logits.argmax(dim=-1).to(torch.int32)
        out.append(tok)
    _sync(device)
    return Generation(torch.cat(out, dim=1), step_logits, t1 - t0, time.perf_counter() - t1)


@torch.inference_mode()
def sharded_greedy_generate(cfg, params, specs, tokens: torch.Tensor, gen: int, *,
                            max_len: Optional[int] = None,
                            image_embeds: Optional[torch.Tensor] = None) -> Generation:
    """:func:`greedy_generate` of the token-input families (dense, moe, ssm,
    hybrid, vlm) over a mesh, inside ``activation_sharding``:
    ``sharded_prefill`` and ``sharded_decode_step`` on this rank's parameter
    slices (``params`` laid out by ``specs``) and its rows of the prompt
    ``tokens`` (B_local, P) and, for the vlm family, of ``image_embeds``
    (B_local, n_img, d), which the prefill puts into the cache.  Each step's
    logits are gathered over the
    vocabulary's TP slices before the argmax, so every TP rank picks the
    same tokens; ``logits`` holds those whole rows."""
    from repro_torch.distributed.sharding import current_context
    from repro_torch.models.decode import sharded_decode_step, sharded_prefill

    ctx = current_context()

    def whole(logits):
        if logits.shape[-1] < cfg.vocab_size:
            logits = ctx.layout.all_gather(logits, -1, ctx.tp)
        return logits[:, -1]

    p = tokens.shape[1]
    batch = {"tokens": tokens}
    if image_embeds is not None:
        batch["image_embeds"] = image_embeds
    _sync(tokens.device)
    t0 = time.perf_counter()
    logits, cache = sharded_prefill(cfg, params, specs, batch, max_len=max_len or p + gen,
                                    last_only=True)
    step_logits = [whole(logits)]
    tok = step_logits[-1][:, None].argmax(dim=-1).to(torch.int32)
    _sync(tokens.device)
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = sharded_decode_step(cfg, params, specs, cache, {"tokens": tok})
        step_logits.append(whole(logits))
        tok = step_logits[-1][:, None].argmax(dim=-1).to(torch.int32)
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
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)).to(dev)
    extra = {}
    if cfg.family == "vlm":
        extra["image_embeds"] = torch.from_numpy(rng.normal(
            size=(b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)).to(dev)
    if cfg.frame_inputs:
        prompt, extra["frame_embeds"] = None, torch.from_numpy(rng.normal(
            size=(b, p + gen - 1, cfg.d_model)).astype(np.float32)).to(dev)
    out = greedy_generate(DecodeEngine(model), prompt, gen, **extra)
    print(f"{cfg.name} on {dev}: {model.num_params():,} parameters; prefilled {p} tokens x "
          f"{b} in {out.prefill_s:.3f} s ({b * p / out.prefill_s:.1f} tokens/s), greedy-"
          f"decoded {gen} tokens per sequence ({gen - 1} steps in {out.decode_s:.3f} s, "
          f"{b * (gen - 1) / out.decode_s:.1f} tokens/s): {out.tokens[0, :10].tolist()}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
