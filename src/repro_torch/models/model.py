"""The decoder LM of the port: the dense, ssm and hybrid families of
``repro.models.model``.

:class:`Model` is an ``nn.Module`` holding the reference's parameter tree
with the same names and shapes, leaves stacked per layer along axis 0
(``blocks.attn.wq`` is (L, d_model, H*hd)), so a JAX parameter pytree loads
leaf for leaf (:func:`repro_torch.models.convert.params_from_numpy`).  It
provides the seeded init, ``param_shapes()``, ``num_params()``,
``num_active_params()``, ``forward`` returning ``(logits, aux)`` and
``loss`` (next-token cross-entropy, the reference's); ``DecodeEngine``
(``models/decode.py``) adds the KV-cache serving path.

Parameters stay in ``param_dtype`` and are cast to the compute type where
they are used, as the reference does; no cast copy is kept.  They are
created without ``requires_grad``, so serving builds no autograd graph;
``repro_torch.train.step.init_state`` switches them on for training.  With
``cfg.remat`` each layer of a forward that builds a graph runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``).

The ssm family (mamba2-2.7b) is a stack of pre-norm Mamba2 blocks
(``models/ssm.py``); the hybrid family (zamba2-7b) runs one weight-shared
attention + MLP block (``shared_attn``, leaves with a leading dim of 1)
before every group of ``attn_every`` Mamba2 layers and none before the tail
layers; as in the reference, remat covers the Mamba2 layers and not the
shared block.  The moe, vlm and audio families and ``param_specs`` wait
(ROADMAP Queue 1 items 13b and 11).  The model runs on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FAMILIES = ("dense", "ssm", "hybrid")   # the families the port runs
Init = Union[int, str]                  # a fan (N(0, 1) / sqrt(fan)), "ones" or "zeros"


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def param_layout(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Init]]:
    """Each parameter of ``cfg``'s family: its name (the reference's tree
    path, dot-joined), shape and init: a fan (N(0, 1) / sqrt(fan)),
    ``"ones"`` (norm scales, ``d_skip``) or ``"zeros"`` (``a_log`` and
    ``dt_bias``), as the reference's ``Model.init`` draws them."""
    d, ff, v, nl = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    layout = {"embed": ((v, d), d), "final_norm": ((d,), "ones")}
    if not cfg.tie_embeddings:
        layout["lm_head"] = ((d, v), d)

    def attn_mlp(prefix: str, n: int) -> dict:
        out = {
            f"{prefix}.attn_norm": ((n, d), "ones"),
            f"{prefix}.mlp_norm": ((n, d), "ones"),
            f"{prefix}.attn.wq": ((n, d, cfg.attn_dim), d),
            f"{prefix}.attn.wk": ((n, d, cfg.kv_dim), d),
            f"{prefix}.attn.wv": ((n, d, cfg.kv_dim), d),
            f"{prefix}.attn.wo": ((n, cfg.attn_dim, d), cfg.attn_dim),
            f"{prefix}.mlp.w_gate": ((n, d, ff), d),
            f"{prefix}.mlp.w_up": ((n, d, ff), d),
            f"{prefix}.mlp.w_down": ((n, ff, d), ff),
        }
        if cfg.qk_norm:
            out[f"{prefix}.attn.q_norm"] = ((n, cfg.head_dim), "ones")
            out[f"{prefix}.attn.k_norm"] = ((n, cfg.head_dim), "ones")
        return out

    def mamba(n: int) -> dict:
        din, ns, h, k = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
        return {
            "blocks.norm": ((n, d), "ones"),
            "blocks.mamba.w_z": ((n, d, din), d),
            "blocks.mamba.w_x": ((n, d, din), d),
            "blocks.mamba.w_b": ((n, d, ns), d),
            "blocks.mamba.w_c": ((n, d, ns), d),
            "blocks.mamba.w_dt": ((n, d, h), d),
            "blocks.mamba.conv_x": ((n, k, din), k),
            "blocks.mamba.conv_b": ((n, k, ns), k),
            "blocks.mamba.conv_c": ((n, k, ns), k),
            "blocks.mamba.a_log": ((n, h), "zeros"),
            "blocks.mamba.dt_bias": ((n, h), "zeros"),
            "blocks.mamba.d_skip": ((n, h), "ones"),
            "blocks.mamba.norm": ((n, din), "ones"),
            "blocks.mamba.w_out": ((n, din, d), din),
        }

    if cfg.family == "dense":
        layout.update(attn_mlp("blocks", nl))
    elif cfg.family == "ssm":
        layout.update(mamba(nl))
    elif cfg.family == "hybrid":
        layout.update(mamba(nl))
        layout.update(attn_mlp("shared_attn", 1))
    else:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 13b); the port "
            f"runs the {', '.join(FAMILIES)} families")
    return layout


def attention_applications(cfg: ModelConfig) -> int:
    """How many times a forward pass runs attention: once a layer in the
    dense family, never in the ssm family, once a group of ``attn_every``
    layers (the shared block) in the hybrid family."""
    return {"dense": cfg.num_layers, "ssm": 0,
            "hybrid": cfg.num_layers // max(cfg.attn_every, 1)}[cfg.family]


def nest(named) -> Dict:
    """``(dotted name, value)`` pairs as a nested dict: ``"blocks.attn.wq"``
    becomes ``tree["blocks"]["attn"]["wq"]``."""
    tree: Dict = {}
    for name, value in named:
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def param_count(cfg: ModelConfig) -> int:
    """The number of parameters of ``Model(cfg)``, without building it."""
    return sum(math.prod(shape) for shape, _ in param_layout(cfg).values())


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree of ``Model(cfg)`` with shapes and dtypes only
    (tensors on the ``meta`` device), as the reference's ``eval_shape`` of
    ``init``."""
    pdt = dtype_of(cfg.param_dtype)
    return nest((name, torch.empty(shape, dtype=pdt, device="meta"))
                for name, (shape, _) in param_layout(cfg).items())


class Model(nn.Module):
    """Pre-norm decoder for ``cfg``: dense (GQA + SwiGLU, optional qk-norm),
    ssm (Mamba2) or hybrid (Mamba2 and a shared attention + MLP block), with
    a tied or separate head, initialised from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 when omitted) with the
    reference's distribution (:func:`param_layout`).  The numbers differ
    from ``jax.random``'s; load the reference's parameters with
    ``params_from_numpy`` to compare."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layout = param_layout(cfg)   # raises for a family the port does not run
        self.cfg = cfg.validate()
        dev = resolve_device(device)
        pdt = dtype_of(cfg.param_dtype)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        for name, (shape, init) in layout.items():
            if init == "ones":
                t = torch.ones(shape, dtype=pdt, device=dev)
            elif init == "zeros":
                t = torch.zeros(shape, dtype=pdt, device=dev)
            else:
                t = torch.randn(shape, generator=generator, dtype=torch.float32,
                                device=dev).mul_(init ** -0.5).to(pdt)
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

    def param_tree(self) -> Dict:
        """The parameters as the reference's nested tree (``{"blocks":
        {"attn": {"wq": ...}}}``), the model's own tensors."""
        return nest(self.named_parameters())

    def param_shapes(self) -> Dict:
        return param_shapes(self.cfg)

    def num_active_params(self) -> int:
        """Active parameters per token: all of them in the ported families
        (the MoE family's expert discount comes with it, ROADMAP item 13b)."""
        return param_count(self.cfg)

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

    def block(self, x: torch.Tensor, blk: Dict, triangle: bool = False) -> torch.Tensor:
        """One decoder layer: attention and MLP, each pre-norm and residual."""
        cfg = self.cfg
        x = x + L.attention_block(
            L.rms_norm(x, blk["attn_norm"], cfg.norm_eps), blk["attn"],
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps, triangle_schedule=triangle)
        return self.mlp(x, blk)

    def mamba_layer(self, x: torch.Tensor, blk: Dict) -> torch.Tensor:
        """One Mamba2 layer of the ssm and hybrid families, pre-norm and
        residual."""
        cfg = self.cfg
        h, _ = ssm_lib.mamba2_block(
            L.rms_norm(x, blk["norm"], cfg.norm_eps), blk["mamba"], d_state=cfg.ssm_state,
            head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps)
        return x + h

    def layers(self) -> list:
        """Every layer's parameters as the reference's per-layer dicts (dense:
        ``{"attn_norm", "mlp_norm", "attn": {...}, "mlp": {...}}``; ssm and
        hybrid: ``{"norm", "mamba": {...}}``), views from one ``unbind`` of
        each stacked leaf (so a backward writes each stacked gradient once,
        not once a layer)."""
        parts = {name: p.unbind(0) for name, p in self.blocks.named_parameters()}
        return [nest((name, views[i]) for name, views in parts.items())
                for i in range(self.cfg.num_layers)]

    def shared_layer(self) -> Dict:
        """The hybrid family's shared attention + MLP block as a per-layer
        dict (index 0 of each ``shared_attn`` leaf)."""
        return nest((name, p[0]) for name, p in self.shared_attn.named_parameters())

    def shared_before(self, i: int) -> bool:
        """Whether the hybrid family's shared block runs before layer ``i``:
        at the start of each of the num_layers // attn_every groups."""
        period = self.cfg.attn_every
        return i % period == 0 and i < self.cfg.num_layers // period * period

    def forward(self, batch: Dict[str, torch.Tensor], *,
                triangle: bool = False) -> Tuple[torch.Tensor, dict]:
        """batch: tokens (B, S).  Returns (logits (B, S, V), aux metrics).
        ``triangle`` is the reference's lower-triangle attention schedule."""
        fam = self.cfg.family
        x = self.embed_tokens(batch["tokens"])
        remat = self.cfg.remat and torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())
        layer = self.block if fam == "dense" else self.mamba_layer
        extra = (triangle,) if fam == "dense" else ()
        shared = self.shared_layer() if fam == "hybrid" else None
        for i, blk in enumerate(self.layers()):
            if shared is not None and self.shared_before(i):
                x = self.block(x, shared, triangle)
            if remat:
                x = checkpoint(layer, x, blk, *extra, use_reentrant=False)
            else:
                x = layer(x, blk, *extra)
        return self.head(x), {}

    def loss(self, batch: Dict[str, torch.Tensor], *,
             triangle: bool = False) -> Tuple[torch.Tensor, dict]:
        """Next-token cross-entropy over float32 logits: the mean of
        logsumexp - gold logit, or its ``loss_mask``-weighted mean.  batch:
        tokens and labels (B, S), integer.  Returns (loss, {"nll", "loss"})."""
        logits, aux = self.forward(batch, triangle=triangle)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, batch["labels"].long()[..., None], dim=-1)[..., 0]
        nll = logz - gold
        mask = batch.get("loss_mask")
        if mask is None:
            loss = nll.mean()
        else:
            mask = mask.float()
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        metrics = {"nll": loss, **aux}
        metrics["loss"] = loss
        return loss, metrics
