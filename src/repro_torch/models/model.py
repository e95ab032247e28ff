"""The decoder LM of the port: the dense family of ``repro.models.model``.

:class:`Model` is an ``nn.Module`` holding the reference's parameter tree
with the same names and shapes, leaves stacked per layer along axis 0
(``blocks.attn.wq`` is (L, d_model, H*hd)), so a JAX parameter pytree loads
leaf for leaf (:func:`repro_torch.models.convert.params_from_numpy`).  It
provides the seeded init, ``num_params()`` and ``forward`` returning
``(logits, aux)``; ``DecodeEngine`` (``models/decode.py``) adds the KV-cache
serving path.

Parameters stay in ``param_dtype`` and are cast to the compute type where
they are used, as the reference does; no cast copy is kept.  The training
slice (``loss``, the flash backward, ``param_specs``) and the other
families wait (ROADMAP Queue 1 item 13), so parameters are created without
``requires_grad``.  The model runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def param_layout(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Optional[int]]]:
    """Each parameter of the dense family: its name (the reference's tree
    path, dot-joined), shape and init fan (N(0, 1) / sqrt(fan); ``None``
    for a norm scale, initialised to ones)."""
    d, ff, v, nl = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    layout = {"embed": ((v, d), d), "final_norm": ((d,), None)}
    if not cfg.tie_embeddings:
        layout["lm_head"] = ((d, v), d)
    layout.update({
        "blocks.attn_norm": ((nl, d), None),
        "blocks.mlp_norm": ((nl, d), None),
        "blocks.attn.wq": ((nl, d, cfg.attn_dim), d),
        "blocks.attn.wk": ((nl, d, cfg.kv_dim), d),
        "blocks.attn.wv": ((nl, d, cfg.kv_dim), d),
        "blocks.attn.wo": ((nl, cfg.attn_dim, d), cfg.attn_dim),
        "blocks.mlp.w_gate": ((nl, d, ff), d),
        "blocks.mlp.w_up": ((nl, d, ff), d),
        "blocks.mlp.w_down": ((nl, ff, d), ff),
    })
    if cfg.qk_norm:
        layout["blocks.attn.q_norm"] = ((nl, cfg.head_dim), None)
        layout["blocks.attn.k_norm"] = ((nl, cfg.head_dim), None)
    return layout


def param_count(cfg: ModelConfig) -> int:
    """The number of parameters of ``Model(cfg)``, without building it."""
    return sum(math.prod(shape) for shape, _ in param_layout(cfg).values())


class Model(nn.Module):
    """Dense pre-norm decoder (GQA + SwiGLU, optional qk-norm, tied or
    separate head) for ``cfg``, initialised from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 when omitted) with the
    reference's distribution (:func:`param_layout`).  The numbers differ
    from ``jax.random``'s; load the reference's parameters with
    ``params_from_numpy`` to compare."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 13); "
                f"the port runs the dense family")
        self.cfg = cfg.validate()
        dev = resolve_device(device)
        pdt = dtype_of(cfg.param_dtype)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        for name, (shape, fan) in param_layout(cfg).items():
            if fan is None:
                t = torch.ones(shape, dtype=pdt, device=dev)
            else:
                t = torch.randn(shape, generator=generator, dtype=torch.float32,
                                device=dev).mul_(fan ** -0.5).to(pdt)
            *path, leaf = name.split(".")
            owner = self
            for part in path:
                if part not in owner._modules:
                    owner.add_module(part, nn.Module())
                owner = owner._modules[part]
            owner.register_parameter(leaf, nn.Parameter(t, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def layer(self, i: int) -> Dict:
        """Layer ``i``'s parameters as the reference's per-layer dict (views
        of the stacked leaves)."""
        blk = self.blocks
        return {"attn_norm": blk.attn_norm[i], "mlp_norm": blk.mlp_norm[i],
                "attn": {n: p[i] for n, p in blk.attn.named_parameters()},
                "mlp": {n: p[i] for n, p in blk.mlp.named_parameters()}}

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        # Gathering before the cast gives the reference's embed.astype(cdt)[tokens].
        return self.embed[tokens].to(dtype_of(self.cfg.dtype))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the output projection: (B, S, d) -> (B, S, V)."""
        cfg = self.cfg
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        return x @ w.to(x.dtype)

    def mlp(self, x: torch.Tensor, blk: Dict) -> torch.Tensor:
        h = L.rms_norm(x, blk["mlp_norm"], self.cfg.norm_eps)
        return x + L.swiglu(h, blk["mlp"]["w_gate"], blk["mlp"]["w_up"],
                            blk["mlp"]["w_down"])

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, dict]:
        """batch: tokens (B, S).  Returns (logits (B, S, V), aux metrics)."""
        cfg = self.cfg
        x = self.embed_tokens(batch["tokens"])
        for i in range(cfg.num_layers):
            blk = self.layer(i)
            x = x + L.attention_block(
                L.rms_norm(x, blk["attn_norm"], cfg.norm_eps), blk["attn"],
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)
            x = self.mlp(x, blk)
        return self.head(x), {}
