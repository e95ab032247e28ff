"""Assigned input shapes: the port's copy of ``repro.configs.shapes``.

Four shapes per architecture:
  train_4k     seq=4096,   global_batch=256  -> train_step
  prefill_32k  seq=32768,  global_batch=32   -> prefill_step
  decode_32k   seq=32768,  global_batch=128  -> serve_step (1 new token)
  long_500k    seq=524288, global_batch=1    -> serve_step (SSM/hybrid only)

``input_specs(cfg, shape)`` gives every model input as a tensor on the
``meta`` device (shape and dtype, no storage), the counterpart of the
reference's ``ShapeDtypeStruct``s, for the dry run
(``repro_torch.launch.dryrun``); ``demo_batch`` a small concrete batch
drawn as the reference draws it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k only for sub-quadratic archs."""
    if shape == "long_500k":
        return cfg.subquadratic
    return True


def input_specs(cfg: ModelConfig, shape) -> Dict[str, torch.Tensor]:
    """Model inputs as ``meta`` tensors (no allocation): ``tokens`` (and
    ``labels`` for a train shape) int32 (B, S), or ``frame_embeds`` bf16
    (B, S, d) for a frame-input model; ``image_embeds`` bf16 (B, n_img, d)
    for the vlm family outside decode.  A decode shape has S = 1.
    ``shape``: a name in :data:`SHAPES`, or a :class:`ShapeSpec`."""
    sp = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    b, s = sp.global_batch, sp.seq_len
    seq = 1 if sp.kind == "decode" else s

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs: Dict[str, torch.Tensor] = {}
    if cfg.frame_inputs:
        specs["frame_embeds"] = meta((b, seq, cfg.d_model), torch.bfloat16)
    else:
        specs["tokens"] = meta((b, seq), torch.int32)
    if sp.kind == "train":
        specs["labels"] = meta((b, seq), torch.int32)
    if cfg.family == "vlm" and sp.kind != "decode":
        specs["image_embeds"] = meta((b, cfg.num_image_tokens, cfg.d_model), torch.bfloat16)
    return specs


def demo_batch(cfg: ModelConfig, batch: int, seq: int, rng=None,
               device=None) -> Dict[str, torch.Tensor]:
    """A small concrete batch for smoke runs and the examples, drawn from the
    numpy generator ``rng`` (default: seed 0) in the reference's order, so
    the same seed gives the reference's values; on ``device`` (the card by
    default)."""
    rng = rng or np.random.default_rng(0)
    device = torch.device(device or "cuda")
    out: Dict[str, torch.Tensor] = {}
    if cfg.frame_inputs:
        out["frame_embeds"] = torch.from_numpy(
            rng.normal(size=(batch, seq, cfg.d_model)).astype("float32")).to(
                device=device, dtype=torch.bfloat16)
    else:
        out["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)).to(device)
    out["labels"] = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)).to(device)
    if cfg.family == "vlm":
        out["image_embeds"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.num_image_tokens, cfg.d_model)).astype("float32")).to(
                device=device, dtype=torch.bfloat16)
    return out
