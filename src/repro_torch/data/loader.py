"""Deterministic, checkpointable LM batch pipeline, the port of
``repro.data.loader``.

``SyntheticLMLoader`` draws each batch from ``np.random.default_rng((seed,
step))`` exactly as the reference does, so both packages see the same
tokens; the batch goes to the loader's device (the card unless the caller
asks for the CPU).  Its state is a tiny dict (step, seed), saved beside the
model's checkpoint so a restart resumes mid-epoch.  Sharding the batch over
a mesh waits for multi-GPU (ROADMAP Queue 1 item 11); the frame-input and
vision batches for their families (item 13b).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    vocab_size: int = 256


class SyntheticLMLoader:
    """Deterministic synthetic token stream with a checkpointable cursor."""

    def __init__(self, model_cfg: ModelConfig, cfg: LoaderConfig, *, device=None):
        if model_cfg.frame_inputs or model_cfg.family == "vlm":
            raise NotImplementedError(
                f"{model_cfg.name}: frame-input and vision batches come with their model "
                f"families (ROADMAP Queue 1 item 13b)")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state: Dict[str, Any] = {"step": 0, "seed": cfg.seed}

    # --- checkpointable state ---
    def state_dict(self) -> Dict[str, Any]:
        return dict(self.state)

    def load_state_dict(self, st: Dict[str, Any]) -> None:
        self.state = dict(st)

    # --- deterministic batch synthesis ---
    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The batch of ``step`` as int32 numpy arrays, tokens and labels
        (B, S): the reference's ``_host_batch``."""
        cfg = self.cfg
        rng = np.random.default_rng((self.state["seed"], step))
        v = min(cfg.vocab_size, self.model_cfg.vocab_size)
        toks = rng.integers(0, v, size=(cfg.batch_size, cfg.seq_len + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = self.host_batch(self.state["step"])
        self.state["step"] += 1
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}
