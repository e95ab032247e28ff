"""Deterministic, checkpointable LM batch pipeline, the port of
``repro.data.loader``.

``SyntheticLMLoader`` draws each batch from ``np.random.default_rng((seed,
step))`` exactly as the reference does, so both packages see the same
tokens, frame embeddings (frame-input models) and image embeddings (the vlm
family), the embeddings rounded to bf16 as the reference rounds them; the
batch goes to the loader's device (the card unless the caller asks for the
CPU).  Its state is a tiny dict (step, seed), saved beside the model's
checkpoint so a restart resumes mid-epoch.  Given a mesh, each rank keeps
only its rows of the global batch (block i of the batch axes' row-major
index i, as the reference's ``make_array_from_callback`` hands each device
its shard), the same rows the single-device loader gives; the TP ranks of a
batch rank get the same rows.
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

    def __init__(self, model_cfg: ModelConfig, cfg: LoaderConfig, *, device=None, mesh=None,
                 batch_axes=("pod", "data")):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rows = slice(None)
        if mesh is not None:
            from repro_torch.distributed.sharding import layout_of

            layout = layout_of(mesh)
            axes = tuple(a for a in batch_axes if a in layout.sizes)
            n = layout.size(axes)
            if cfg.batch_size % n:
                raise ValueError(f"batch {cfg.batch_size} does not divide over {axes} ({n})")
            per = cfg.batch_size // n
            self.rows = slice(layout.index(axes) * per, (layout.index(axes) + 1) * per)
        self.state: Dict[str, Any] = {"step": 0, "seed": cfg.seed}

    # --- checkpointable state ---
    def state_dict(self) -> Dict[str, Any]:
        return dict(self.state)

    def load_state_dict(self, st: Dict[str, Any]) -> None:
        self.state = dict(st)

    # --- deterministic batch synthesis ---
    def host_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch of ``step`` on the host, the reference's ``_host_batch``
        drawn in its order: int32 tokens (B, S) (or, for a frame-input model,
        bf16 frame_embeds (B, S, d)) and labels (B, S), and for the vlm
        family bf16 image_embeds (B, n_img, d)."""
        cfg, mc = self.cfg, self.model_cfg
        rng = np.random.default_rng((self.state["seed"], step))
        b, s = cfg.batch_size, cfg.seq_len
        v = min(cfg.vocab_size, mc.vocab_size)
        toks = torch.from_numpy(rng.integers(0, v, size=(b, s + 1), dtype=np.int32))
        out: Dict[str, torch.Tensor] = {}
        if mc.frame_inputs:
            out["frame_embeds"] = _bf16(rng.normal(size=(b, s, mc.d_model)))
        else:
            out["tokens"] = toks[:, :-1]
        out["labels"] = toks[:, 1:]
        if mc.family == "vlm":
            out["image_embeds"] = _bf16(rng.normal(size=(b, mc.num_image_tokens, mc.d_model)))
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = self.host_batch(self.state["step"])
        self.state["step"] += 1
        return {k: v[self.rows].contiguous().to(self.device) for k, v in batch.items()}


def _bf16(a: np.ndarray) -> torch.Tensor:
    """float64 draws rounded to float32, then to bf16 (round to nearest
    even), as the reference's ``astype(np.float32).astype(jnp.bfloat16)``."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
