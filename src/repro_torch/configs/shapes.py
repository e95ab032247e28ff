"""Assigned input shapes: the port's copy of ``repro.configs.shapes``.

Four shapes per architecture:
  train_4k     seq=4096,   global_batch=256  -> train_step
  prefill_32k  seq=32768,  global_batch=32   -> prefill_step
  decode_32k   seq=32768,  global_batch=128  -> serve_step (1 new token)
  long_500k    seq=524288, global_batch=1    -> serve_step (SSM/hybrid only)

The reference's ``input_specs`` builds dry-run ``ShapeDtypeStruct``s; it
waits for the port's dry run (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

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
