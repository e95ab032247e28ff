"""The decoder LM of the port: the six families of ``repro.models.model``
(dense, moe, ssm, hybrid, vlm, audio).

:class:`Model` is an ``nn.Module`` holding the reference's parameter tree
with the same names and shapes, leaves stacked per layer along axis 0
(``blocks.attn.wq`` is (L, d_model, H*hd)), so a JAX parameter pytree loads
leaf for leaf (:func:`repro_torch.models.convert.params_from_numpy`).  It
provides the seeded init, ``param_shapes()``, ``num_params()``,
``num_active_params()``, ``forward`` returning ``(logits, aux)`` and
``loss`` (next-token cross-entropy plus the MoE auxiliary terms, the
reference's); ``DecodeEngine`` (``models/decode.py``) adds the KV-cache
serving path.

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
shared block.  The moe family (phi3.5-moe, arctic) replaces the MLP by the
routed experts of ``models/moe.py`` (arctic adds a dense MLP beside them);
remat covers attention and experts together, and ``forward`` returns the
layers' mean of the aux metrics.  The vlm family (llama-3.2-vision) runs
one gated cross-attention + MLP block (``cross_blocks``, ``gate`` starting
at zero) over ``batch["image_embeds"]`` after every ``cross_attn_every``
self layers: no RoPE, non-causal, outside remat.  The audio family
(musicgen) is the dense decoder fed ``batch["frame_embeds"]`` in place of
the embedding lookup (``embed`` is then unused).  The model runs on the
card unless the caller passes ``device="cpu"``.

Sharding: :func:`param_specs` (and ``Model.param_specs``) is the
reference's rule set, a pure function of the config's shapes for every
family; :func:`sharded_loss` is the loss of every family on one rank's
shards of the parameters and the batch, Megatron style (experts parallel
over TP, attention over heads or, where neither the KV nor the q heads
divide TP, over the q sequence, the SSD heads over TP), for
``repro_torch.train.step.sharded_train_step``, and ``models/decode.py``'s
``sharded_prefill`` / ``sharded_decode_step`` serve from the same shards,
all through :class:`_ShardedDecoder`'s one copy of the layer.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
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

    def mlp(prefix: str, n: int) -> dict:
        return {f"{prefix}.w_gate": ((n, d, ff), d), f"{prefix}.w_up": ((n, d, ff), d),
                f"{prefix}.w_down": ((n, ff, d), ff)}

    def attn(prefix: str, n: int) -> dict:
        out = {
            f"{prefix}.attn_norm": ((n, d), "ones"),
            f"{prefix}.mlp_norm": ((n, d), "ones"),
            f"{prefix}.attn.wq": ((n, d, cfg.attn_dim), d),
            f"{prefix}.attn.wk": ((n, d, cfg.kv_dim), d),
            f"{prefix}.attn.wv": ((n, d, cfg.kv_dim), d),
            f"{prefix}.attn.wo": ((n, cfg.attn_dim, d), cfg.attn_dim),
        }
        if cfg.qk_norm:
            out[f"{prefix}.attn.q_norm"] = ((n, cfg.head_dim), "ones")
            out[f"{prefix}.attn.k_norm"] = ((n, cfg.head_dim), "ones")
        return out

    def attn_mlp(prefix: str, n: int) -> dict:
        return {**attn(prefix, n), **mlp(f"{prefix}.mlp", n)}

    def moe(n: int) -> dict:
        # The reference's dense() takes shape[-2] as the fan: d for the
        # router and the (E, d, F) experts, F for w_down.
        e, f = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
        return {"blocks.moe.router": ((n, d, e), d),
                "blocks.moe.w_gate": ((n, e, d, f), d),
                "blocks.moe.w_up": ((n, e, d, f), d),
                "blocks.moe.w_down": ((n, e, f, d), f)}

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

    fam = cfg.family
    if fam in ("dense", "audio"):
        layout.update(attn_mlp("blocks", nl))
    elif fam == "moe":
        layout.update(attn("blocks", nl))
        layout.update(moe(nl))
        if cfg.dense_residual:
            layout.update(mlp("blocks.dense_mlp", nl))
    elif fam == "ssm":
        layout.update(mamba(nl))
    elif fam == "hybrid":
        layout.update(mamba(nl))
        layout.update(attn_mlp("shared_attn", 1))
    elif fam == "vlm":
        n_cross = num_cross_layers(cfg)
        n_self = nl - n_cross
        assert n_self == n_cross * cfg.cross_attn_every, (
            "vlm layer count must decompose as n_cross * (cross_attn_every + 1)")
        layout.update(attn_mlp("blocks", n_self))
        layout.update(attn_mlp("cross_blocks", n_cross))
        layout["cross_blocks.gate"] = ((n_cross,), "zeros")
    else:
        raise ValueError(f"unknown family {fam!r}; one of {FAMILIES}")
    return layout


def num_cross_layers(cfg: ModelConfig) -> int:
    """The vlm family's number of cross-attention layers (of num_layers)."""
    return cfg.num_layers // (cfg.cross_attn_every + 1) if cfg.family == "vlm" else 0


def attention_applications(cfg: ModelConfig) -> int:
    """How many times a forward pass runs attention: once a layer in the
    dense, moe, audio and vlm families (the vlm's cross-attention layers
    included), never in the ssm family, once a group of ``attn_every``
    layers (the shared block) in the hybrid family."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


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


def active_param_count(cfg: ModelConfig) -> int:
    """Active parameters per token, without building the model: the routed
    experts' leaves count k / E of their size (floored, as the reference's
    ``num_active_params``)."""
    total = 0
    for name, (shape, _) in param_layout(cfg).items():
        size = math.prod(shape)
        if name.startswith("blocks.moe.w_"):
            size = size * cfg.experts_per_token // cfg.num_experts
        total += size
    return total


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree of ``Model(cfg)`` with shapes and dtypes only
    (tensors on the ``meta`` device), as the reference's ``eval_shape`` of
    ``init``."""
    pdt = dtype_of(cfg.param_dtype)
    return nest((name, torch.empty(shape, dtype=pdt, device="meta"))
                for name, (shape, _) in param_layout(cfg).items())


class Model(nn.Module):
    """Pre-norm decoder for ``cfg``: dense or audio (GQA + SwiGLU, optional
    qk-norm), moe (routed experts in place of the MLP), ssm (Mamba2), hybrid
    (Mamba2 and a shared attention + MLP block) or vlm (gated
    cross-attention layers among the self layers), with a tied or separate
    head, initialised from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 when omitted) with the
    reference's distribution (:func:`param_layout`).  The numbers differ
    from ``jax.random``'s; load the reference's parameters with
    ``params_from_numpy`` to compare."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layout = param_layout(cfg)
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

    def param_specs(self, mesh, fsdp: Tuple[str, ...] = ("pod", "data"),
                    tp: str = "model") -> Dict:
        """The specs of :meth:`param_tree` on ``mesh`` (:func:`param_specs`)."""
        return param_specs(self.cfg, mesh, fsdp=fsdp, tp=tp)

    def num_active_params(self) -> int:
        """Active parameters per token (the moe family discounts its
        inactive experts)."""
        return active_param_count(self.cfg)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        # Gathering before the cast gives the reference's embed.astype(cdt)[tokens].
        return self.embed[tokens].to(dtype_of(self.cfg.dtype))

    def inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The first layer's input: ``frame_embeds`` (B, S, d) in the compute
        type for a frame-input model, else the embedded ``tokens``."""
        if self.cfg.frame_inputs:
            return batch["frame_embeds"].to(dtype_of(self.cfg.dtype))
        return self.embed_tokens(batch["tokens"])

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

    def attend(self, x: torch.Tensor, blk: Dict, triangle: bool = False, *,
               kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """Pre-norm attention over x, or over ``kv`` (cross-attention:
        non-causal, no RoPE), without the residual."""
        cfg = self.cfg
        return L.attention_block(
            L.rms_norm(x, blk["attn_norm"], cfg.norm_eps), blk["attn"],
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps, kv_override=kv,
            triangle_schedule=triangle)

    def block(self, x: torch.Tensor, blk: Dict, triangle: bool = False) -> torch.Tensor:
        """One decoder layer: attention and MLP, each pre-norm and residual."""
        return self.mlp(x + self.attend(x, blk, triangle), blk)

    def experts(self, h: torch.Tensor, blk: Dict) -> Tuple[torch.Tensor, dict]:
        """The moe family's MLP on normed ``h``: the routed experts, plus the
        dense MLP beside them when ``dense_residual`` (arctic).  Returns
        (out, aux metrics)."""
        cfg = self.cfg
        out, aux = moe_lib.moe_block(h, blk["moe"], num_experts=cfg.num_experts,
                                     k=cfg.experts_per_token,
                                     capacity_factor=cfg.capacity_factor)
        if cfg.dense_residual:
            dense = blk["dense_mlp"]
            out = out + L.swiglu(h, dense["w_gate"], dense["w_up"], dense["w_down"])
        return out, aux

    def moe_layer(self, x: torch.Tensor, blk: Dict,
                  triangle: bool = False) -> Tuple[torch.Tensor, dict]:
        """One moe layer: attention, then the experts, each pre-norm and
        residual.  Returns (x, aux metrics)."""
        x = x + self.attend(x, blk, triangle)
        out, aux = self.experts(L.rms_norm(x, blk["mlp_norm"], self.cfg.norm_eps), blk)
        return x + out, aux

    def image_kv(self, cblk: Dict, image_embeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A cross layer's K and V (B, n_img, KV, hd) of the image embeddings
        (in the compute type)."""
        cfg = self.cfg
        b, n = image_embeds.shape[:2]
        return tuple((image_embeds @ cblk["attn"][w].to(image_embeds.dtype))
                     .reshape(b, n, cfg.num_kv_heads, cfg.head_dim) for w in ("wk", "wv"))

    def gated(self, x: torch.Tensor, cblk: Dict, h: torch.Tensor) -> torch.Tensor:
        """The rest of a cross layer after its attention output ``h`` (after
        wo): x + tanh(gate) h, then the MLP's output scaled by the same gate."""
        gate = torch.tanh(cblk["gate"]).to(x.dtype)
        x = x + gate * h
        mlp = cblk["mlp"]
        return x + gate * L.swiglu(L.rms_norm(x, cblk["mlp_norm"], self.cfg.norm_eps),
                                   mlp["w_gate"], mlp["w_up"], mlp["w_down"])

    def cross_block(self, x: torch.Tensor, cblk: Dict,
                    image_embeds: torch.Tensor) -> torch.Tensor:
        """One vlm cross layer over ``image_embeds`` (B, n_img, d)."""
        return self.gated(x, cblk, self.attend(x, cblk, kv=self.image_kv(cblk, image_embeds)))

    def mamba_layer(self, x: torch.Tensor, blk: Dict) -> torch.Tensor:
        """One Mamba2 layer of the ssm and hybrid families, pre-norm and
        residual."""
        cfg = self.cfg
        h, _ = ssm_lib.mamba2_block(
            L.rms_norm(x, blk["norm"], cfg.norm_eps), blk["mamba"], d_state=cfg.ssm_state,
            head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps)
        return x + h

    def layers(self) -> list:
        """Every layer of ``blocks`` as the reference's per-layer dicts (dense,
        audio and the vlm's self layers: ``{"attn_norm", "mlp_norm", "attn":
        {...}, "mlp": {...}}``; moe: ``"moe"`` (and ``"dense_mlp"``) in place
        of ``"mlp"``; ssm and hybrid: ``{"norm", "mamba": {...}}``), as
        :func:`_per_layer` gives them."""
        return _per_layer(self.blocks)

    def cross_layers(self) -> list:
        """The vlm family's cross layers as per-layer dicts (``{"attn_norm",
        "attn", "gate", "mlp_norm", "mlp"}``), as :meth:`layers`."""
        return _per_layer(self.cross_blocks)

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
        """batch: tokens (B, S), or frame_embeds (B, S, d) for a frame-input
        model, and image_embeds (B, n_img, d) for the vlm family.  Returns
        (logits (B, S, V), aux metrics: the moe family's ``moe_aux_loss``,
        ``moe_z_loss`` and ``moe_dropped``, each the mean over layers).
        ``triangle`` is the reference's lower-triangle attention schedule."""
        cfg = self.cfg
        fam = cfg.family
        x = self.inputs(batch)
        remat = cfg.remat and torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())

        def run(layer, *args):
            return checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)

        aux: dict = {}
        if fam in ("ssm", "hybrid"):
            shared = self.shared_layer() if fam == "hybrid" else None
            for i, blk in enumerate(self.layers()):
                if shared is not None and self.shared_before(i):
                    x = self.block(x, shared, triangle)
                x = run(self.mamba_layer, x, blk)
        elif fam == "moe":
            for blk in self.layers():
                x, layer_aux = run(self.moe_layer, x, blk, triangle)
                aux = {k: aux.get(k, 0.0) + v.float() for k, v in layer_aux.items()}
            aux = {k: v / cfg.num_layers for k, v in aux.items()}
        else:
            cross = self.cross_layers() if fam == "vlm" else []
            if cross:
                images = batch["image_embeds"].to(dtype_of(cfg.dtype))
            for i, blk in enumerate(self.layers()):
                x = run(self.block, x, blk, triangle)
                if cross and (i + 1) % cfg.cross_attn_every == 0:
                    x = self.cross_block(x, cross[i // cfg.cross_attn_every], images)
        return self.head(x), aux

    def loss(self, batch: Dict[str, torch.Tensor], *,
             triangle: bool = False) -> Tuple[torch.Tensor, dict]:
        """Next-token cross-entropy over float32 logits: the mean of
        logsumexp - gold logit, or its ``loss_mask``-weighted mean.  batch:
        tokens (or frame_embeds, and image_embeds, as :meth:`forward` takes
        them) and labels (B, S), integer.  The moe family adds
        ``aux_loss_coef * moe_aux_loss + router_z_coef * moe_z_loss``.
        Returns (loss, {"nll", "loss"} and the aux metrics)."""
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
        if "moe_aux_loss" in aux:
            cfg = self.cfg
            loss = loss + cfg.aux_loss_coef * aux["moe_aux_loss"] \
                + cfg.router_z_coef * aux["moe_z_loss"]
        metrics["loss"] = loss
        return loss, metrics


def _per_layer(stack: nn.Module) -> list:
    """Views of each of ``stack``'s stacked leaves, one nested dict a layer,
    from one ``unbind`` of each leaf (so a backward writes each stacked
    gradient once, not once a layer)."""
    parts = {name: p.unbind(0) for name, p in stack.named_parameters()}
    n = len(next(iter(parts.values())))
    return [nest((name, views[i]) for name, views in parts.items()) for i in range(n)]


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------

_STACKED = ("blocks", "cross_blocks", "shared_attn")
_COLUMN = ("wq", "wk", "wv", "w_gate", "w_up", "w_z", "w_x", "w_b", "w_c", "w_dt")
_ROW = ("wo", "w_down", "w_out")
# A Mamba2 layer's leaves that keep their TP slice where the SSD heads divide
# TP, by the dim their spec shards over it (the layer's own dims); B, C and
# their convs are gathered whole: the SSD contraction needs every N on every
# rank.
_SSM_TP_DIM = {"w_z": 1, "w_x": 1, "w_dt": 1, "conv_x": 1, "a_log": 0, "dt_bias": 0,
               "d_skip": 0, "norm": 0, "w_out": 0}
_SSM_VECTORS = ("a_log", "dt_bias", "d_skip", "norm")   # read in float32 by the block


def param_specs(cfg: ModelConfig, mesh, fsdp: Tuple[str, ...] = ("pod", "data"),
                tp: str = "model") -> Dict:
    """The reference's ``Model.param_specs``: a spec tree matching
    :func:`param_shapes`.  Every matrix is TP-sharded over ``tp`` on its
    "parallel" dim and FSDP-sharded over the batch axes ``fsdp`` (those the
    mesh has) on the other: q/k/v, gate/up and the Mamba2 input projections
    (fsdp, tp), their (E, D, F) expert forms (tp, fsdp, None); wo/down/out
    (tp, fsdp), experts (tp, None, fsdp); ``embed`` vocab-parallel (tp,
    fsdp); ``lm_head`` (fsdp, tp); ``router`` (fsdp, None); ``conv_x`` its
    channels over TP, ``conv_b`` / ``conv_c`` replicated; the SSD per-head
    vectors over TP; norms replicated.  A stacked leaf (blocks,
    cross_blocks, shared_attn) gets a leading None; a dim that does not
    divide is replicated; an unknown leaf raises.  ``mesh``: anything
    :func:`~repro_torch.distributed.sharding.mesh_sizes` reads."""
    from repro_torch.distributed.sharding import P, axes_size, mesh_sizes

    sizes = mesh_sizes(mesh)
    fsdp = tuple(a for a in fsdp if a in sizes)
    fsdp_size = axes_size(sizes, fsdp) if fsdp else 1
    tp_size = sizes[tp] if tp in sizes else 1

    def ax_f(dim):  # FSDP axes if divisible
        return fsdp if fsdp and dim % fsdp_size == 0 else None

    def ax_t(dim):  # TP axis if divisible
        return tp if tp_size > 1 and dim % tp_size == 0 else None

    def spec_for(path: Tuple[str, ...], shape: Tuple[int, ...]):
        name = path[-1]
        stacked = path[0] in _STACKED
        if name == "embed":
            return P(ax_t(shape[0]), ax_f(shape[1]))
        if name == "lm_head":
            return P(ax_f(shape[0]), ax_t(shape[1]))
        if name == "final_norm":
            return P(None)
        s = shape[1:] if stacked else shape

        def wrap(*spec):
            return P(*(((None,) + spec) if stacked else spec))

        if name in _COLUMN:
            if len(s) == 3:  # MoE expert weights (E, D, F)
                return wrap(ax_t(s[0]), ax_f(s[1]), None)
            return wrap(ax_f(s[0]), ax_t(s[1]))
        if name in _ROW:
            if len(s) == 3:  # (E, F, D)
                return wrap(ax_t(s[0]), None, ax_f(s[1]))
            return wrap(ax_t(s[0]), ax_f(s[1]))
        if name == "router":
            return wrap(ax_f(s[0]), None)
        if name == "conv_x":
            return wrap(None, ax_t(s[1]))
        if name in ("conv_b", "conv_c"):
            return wrap(None, None)
        if name in ("a_log", "dt_bias", "d_skip", "norm"):
            return wrap(ax_t(s[0]))
        if name in ("attn_norm", "mlp_norm", "q_norm", "k_norm"):
            return wrap(None)
        if name == "gate":
            return wrap() if len(s) == 0 else wrap(None)
        raise ValueError(f"no spec rule for {path} {shape}")

    return nest((name, spec_for(tuple(name.split(".")), shape))
                for name, (shape, _) in param_layout(cfg).items())


def _flat(tree: Dict, prefix: str = "") -> list:
    """``[(dotted name, leaf), ...]`` of a nested dict."""
    out = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.extend(_flat(tree[key], f"{prefix}{key}."))
        else:
            out.append((prefix + key, tree[key]))
    return out


class _ShardedDecoder:
    """The decoder of every family on this rank's shards, inside
    :func:`~repro_torch.distributed.sharding.activation_sharding` over a
    ``DeviceMesh``: the one copy of the sharded layer that the loss and the
    serving functions share.

    ``params``: this rank's slices of the parameter tree, laid out by
    ``specs`` (:func:`param_specs`).  Megatron style on local shards: each
    layer all-gathers its FSDP-sharded weights over the batch axes when it
    runs (inside the layer's remat region, so a backward replays the
    gathers in layer order on every rank and the peak holds one layer in
    full; the matrices cast to the compute type before they move, as the
    unsharded step casts them where they are used; each gather's backward
    reduce-scatters the gradient, summed in the parameter type); q/k/v and
    gate/up are column-parallel over the TP axis and wo and down
    row-parallel, their partial outputs all-reduced over it.  Attention
    follows :func:`~repro_torch.distributed.sharding.attn_partition`: the
    heads over TP, or (``q_sequence``) this rank's q rows against the whole
    K and V, the rows all-gathered after wo (the caller's ``attention``
    picks them).  The MLP is column / row parallel when d_ff divides TP,
    else replicated.  The embedding and the head are vocab-parallel when the
    vocabulary divides TP (each rank looks up and scores its vocab slice),
    else gathered whole; a frame-input model (audio) takes ``frame_embeds``
    in place of the embedding.  The moe family's experts are parallel over
    TP when E divides it (every rank routes every token of its rows and runs
    its E / TP experts' kept choices, the float32 partial outputs summed
    over TP; the routing statistics averaged over the batch axes, so the
    aux metrics are the global batch's, :attr:`aux`), arctic's dense MLP
    beside them column / row parallel.  The vlm family's cross blocks (q
    from the text, k and v from this rank's rows of the image embeddings,
    heads per ``attn_partition``, non-causal; the MLP column / row parallel;
    the tanh gate as it is) run outside remat after every
    ``cross_attn_every`` self layers.  A Mamba2 layer (the ssm and hybrid
    families, :meth:`mamba`) runs this rank's SSD heads where they divide TP
    (z, x, dt and ``conv_x`` column slices, the per-head vectors and the
    gated norm's scale its slice, ``w_out`` row-parallel and its output
    partial; B, C and their convs gathered whole; the gated norm's sum of
    squares all-reduced over TP), else every head on every TP rank; the
    hybrid's shared attention + MLP block runs before each group of
    ``attn_every`` layers, outside remat, its gradient the sum over its
    applications.  Under ``seq_parallel`` the residual's
    sequence is sharded over TP between blocks where it divides: each block
    all-gathers it before its norm and reduce-scatters its partial output
    (a replicated output is sliced, a ``q_sequence`` output is already this
    rank's rows), and the final norm sees the whole sequence again."""

    def __init__(self, cfg: ModelConfig, params: Dict, specs: Dict, what: str):
        from repro_torch.distributed.sharding import (AttnPartition, attn_partition, constrain,
                                                      current_context)

        ctx = current_context()
        if ctx is None or ctx.layout is None:
            raise RuntimeError(f"{what} runs inside activation_sharding over a DeviceMesh")
        self.cfg, self.params, self.specs, self.ctx = cfg, params, specs, ctx
        self.lay, self.tp = ctx.layout, ctx.tp
        self.cdt = dtype_of(cfg.dtype)
        # Without a TP axis one rank holds every head: the heads case at TP 1.
        self.part = attn_partition(cfg.num_heads, cfg.num_kv_heads) or AttnPartition(
            "heads", (0, cfg.num_heads), (0, cfg.num_kv_heads))
        self.mlp_tp = constrain((cfg.d_ff,), ("tp",))[0] is not None
        self.vocab_tp = constrain((cfg.vocab_size,), ("tp",))[0] is not None
        self.moe_tp = (cfg.family == "moe"
                       and constrain((cfg.num_experts,), ("tp",))[0] is not None)
        self.ssm_tp = (cfg.family in ("ssm", "hybrid")
                       and constrain((cfg.ssm_heads,), ("tp",))[0] is not None)
        self.emb = None
        self.aux: dict = {}

    def use(self, t, spec, keep=(), cast=False):
        """``t`` (a slice laid out by ``spec``) gathered along every sharded
        dim but those in ``keep``, which stay sharded over TP; with ``cast``
        in the compute type (cast before the last gather, so the gradients
        are still summed in the parameter type).  Axes of one rank gather
        nothing, and a leaf that moves nowhere is not cast here: its users
        cast it where they read it, as the unsharded model does (the moe
        family's expert stacks one expert at a time)."""
        from repro_torch.distributed.sharding import entry_axes

        gathers = []
        for d, e in enumerate(tuple(spec)):
            if d in keep:
                if e is None and self.ctx.tp_size > 1:
                    raise ValueError(f"dim {d} of a {spec} leaf is not sharded over {self.tp}")
            elif entry_axes(e) and self.lay.size(entry_axes(e)) > 1:
                gathers.append((d, entry_axes(e)))
        for i, (d, axes) in enumerate(gathers):
            t = self.lay.gather(t, d, axes,
                                dtype=self.cdt if cast and i == len(gathers) - 1 else None)
        return t

    def attn_weights(self, a: Dict, sa: Dict, *, whole: bool = False) -> Dict:
        """A layer's attention weights for this rank: q's columns and wo's
        rows of its heads, k's and v's of its KV heads in the ``heads``
        case and every KV head's otherwise; in the ``q_sequence`` case every
        head, k's and v's columns this rank's slice where they divide TP
        (the reference's layout: each rank projects its slice of k and v,
        and :meth:`flash_attention` all-gathers them); ``whole``: every
        head, whole."""
        from repro_torch.distributed.sharding import entry_axes

        part = self.part
        heads_tp = part.tp_parallel and not whole
        kv_tp = not whole and (part.case == "heads" or (
            part.case == "q_sequence" and self.tp in entry_axes(tuple(sa["wk"])[1])))
        q_cols = (1,) if heads_tp else ()
        kv_cols = (1,) if kv_tp else ()
        w = {"wq": self.use(a["wq"], sa["wq"], q_cols, cast=True),
             "wk": self.use(a["wk"], sa["wk"], kv_cols, cast=True),
             "wv": self.use(a["wv"], sa["wv"], kv_cols, cast=True),
             "wo": self.use(a["wo"], sa["wo"], (0,) if heads_tp else (), cast=True)}
        for norm in ("q_norm", "k_norm"):
            if norm in a:
                w[norm] = self.use(a[norm], sa[norm])
        return w

    def out_layout(self, seq: int) -> str:
        """How :meth:`flash_attention`'s output after wo lies over TP for a
        sequence of ``seq`` q rows: ``"partial"`` (head-parallel, to be
        summed), ``"rows"`` (this rank's q rows, ``q_sequence``) or
        ``"whole"``."""
        if self.part.tp_parallel:
            return "partial"
        return "rows" if self.part.q_rows(seq) else "whole"

    def _seq_slice(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1] // self.ctx.tp_size
        return x.narrow(1, self.lay.coord[self.tp] * n, n)

    def _combine(self, h: torch.Tensor, layout: str, sp: bool) -> torch.Tensor:
        """A block's output into the residual's layout: ``"partial"``
        outputs summed over TP (reduce-scattered along the sequence under
        SP), ``"rows"`` all-gathered along the sequence (kept under SP, the
        residual's own slice), ``"whole"`` as it is (sliced under SP)."""
        if self.ctx.tp_size > 1 and layout == "partial":
            return self.lay.psum_scatter(h, 1, self.tp) if sp else self.lay.psum(h, self.tp)
        if self.ctx.tp_size > 1 and layout == "rows":
            return h if sp else self.lay.gather(h, 1, self.tp)
        return self._seq_slice(h) if sp else h

    def _batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the batch axes (its adjoint under autograd): the
        routing statistics of the global batch from each rank's rows."""
        axes = self.ctx.batch_axes
        n = self.lay.size(axes) if axes else 1
        return self.lay.psum(t, axes) / n if n > 1 else t

    @staticmethod
    def _partial(split: bool) -> str:
        return "partial" if split else "whole"

    def _mlp(self, h: torch.Tensor, m: Dict, sm: Dict) -> torch.Tensor:
        """SwiGLU on normed ``h``, column / row parallel when d_ff divides
        TP (the output then partial over TP)."""
        cols, rows = ((1,), (0,)) if self.mlp_tp else ((), ())
        return L.swiglu(h, self.use(m["w_gate"], sm["w_gate"], cols, cast=True),
                        self.use(m["w_up"], sm["w_up"], cols, cast=True),
                        self.use(m["w_down"], sm["w_down"], rows, cast=True))

    def _experts(self, h: torch.Tensor, blk: Dict, lspec: Dict, sp: bool):
        """The moe family's MLP on normed ``h`` (whole sequence), in the
        residual's layout: this rank's experts (all of them when E does not
        divide TP) and arctic's dense MLP.  Returns (output, aux metrics of
        the global batch)."""
        cfg = self.cfg
        m, sm = blk["moe"], lspec["moe"]
        keep = (0,) if self.moe_tp else ()
        params = {"router": self.use(m["router"], sm["router"])}
        for name in ("w_gate", "w_up", "w_down"):
            params[name] = self.use(m[name], sm[name], keep, cast=True)
        n = params["w_gate"].shape[0]
        out, aux = moe_lib.moe_block(
            h, params, num_experts=cfg.num_experts, k=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor,
            experts=(self.lay.coord[self.tp] * n, n) if self.moe_tp else None,
            # Serving reads no aux metric: its statistics stay local.
            reduce=self._batch_mean if torch.is_grad_enabled() else None)
        out = self._combine(out, self._partial(self.moe_tp), sp).to(self.cdt)
        if cfg.dense_residual:
            out = out + self._combine(self._mlp(h, blk["dense_mlp"], lspec["dense_mlp"]),
                                      self._partial(self.mlp_tp), sp)
        return out, aux

    def ssm_norm_mean(self, sum_sq: torch.Tensor) -> torch.Tensor:
        """The gated norm's mean square over the whole ``ssm_inner`` from this
        rank's float32 sum of squares of its channels."""
        return self.lay.psum(sum_sq, self.tp) / self.cfg.ssm_inner

    def mamba(self, h: torch.Tensor, m: Dict, sm: Dict,
              cache: Optional[Dict[str, torch.Tensor]] = None):
        """A Mamba2 block on normed ``h`` (whole sequence) with this layer's
        slices ``m`` laid out by ``sm``: this rank's SSD heads where they
        divide TP, else every head (heads that straddle ranks run whole on
        every TP rank).  ``cache``: the layer's decode state as the block
        reads it (``conv_x`` and ``ssm`` of the heads it runs, ``conv_b`` and
        ``conv_c`` whole), for one decode step.  Returns (output, its layout
        over TP, the block's new state in the same layout)."""
        cfg = self.cfg
        w = {name: self.use(t, sm[name],
                            (_SSM_TP_DIM[name],) if self.ssm_tp and name in _SSM_TP_DIM else (),
                            cast=name not in _SSM_VECTORS)
             for name, t in m.items()}
        split = self.ssm_tp and self.ctx.tp_size > 1
        out, new = ssm_lib.mamba2_block(
            h, w, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
            norm_eps=cfg.norm_eps, cache=cache, norm_mean=self.ssm_norm_mean if split else None)
        return out, self._partial(split), new

    def hidden(self, batch: Dict[str, torch.Tensor], attention, *, remat: bool,
               cross_attention=None, mamba=None) -> torch.Tensor:
        """The first layer's input of this rank's rows of ``batch`` (the
        vocab-parallel embedding of ``tokens``, or ``frame_embeds``; the same
        on every TP rank), the layers and the final norm: (B, S, d) in the
        compute type, whole on every TP rank.  ``attention(i, h, a, sa)``
        runs self layer i's attention on its normed input ``h`` (whole
        sequence) with its weight slices ``a`` laid out by ``sa``, and
        returns the output after wo and its layout over TP (``"partial"``,
        ``"rows"`` or ``"whole"``, :meth:`_combine`); the hybrid's shared
        block calls it with its group's index.  ``cross_attention(g, h, a,
        sa)`` likewise for the vlm family's cross layer g; ``mamba(i, h, m,
        sm)`` runs Mamba2 layer i on its normed input and returns its output
        and layout (by default :meth:`mamba` without a cache).  The moe
        family's aux metrics (the layers' mean) are left in :attr:`aux`."""
        from repro_torch.distributed.sharding import P

        cfg, lay, tp = self.cfg, self.lay, self.tp
        params, specs = self.params, self.specs
        if cfg.frame_inputs:
            x = batch["frame_embeds"].to(self.cdt)
        else:
            # Without a gradient to keep in the parameter type (serving), the
            # embedding moves in the compute type: a lookup and its cast commute.
            serving = not (torch.is_grad_enabled() and params["embed"].requires_grad)
            emb = self.use(params["embed"], specs["embed"], (0,) if self.vocab_tp else (),
                           cast=serving)
            self.emb = emb
            tokens = batch["tokens"].long()
            if self.vocab_tp:
                local = tokens - lay.coord[tp] * emb.shape[0]
                inside = (local >= 0) & (local < emb.shape[0])
                x = torch.where(inside[..., None], emb[local.clamp(0, emb.shape[0] - 1)], 0.0)
                x = lay.psum(x, tp).to(self.cdt)
            else:
                x = emb[tokens].to(self.cdt)
        sp = (self.ctx.seq_parallel and self.ctx.tp_size > 1
              and x.shape[1] % self.ctx.tp_size == 0)
        if sp:
            x = self._seq_slice(x)

        def norm(x, scale, spec):
            xin = lay.gather(x, 1, tp) if sp else x
            return L.rms_norm(xin, self.use(scale, spec), cfg.norm_eps)

        def layer(x, blk, lspec, i):
            h, out = attention(i, norm(x, blk["attn_norm"], lspec["attn_norm"]), blk["attn"],
                               lspec["attn"])
            x = x + self._combine(h, out, sp)
            h = norm(x, blk["mlp_norm"], lspec["mlp_norm"])
            if "moe" in blk:
                out, aux = self._experts(h, blk, lspec, sp)
                return x + out, aux
            return x + self._combine(self._mlp(h, blk["mlp"], lspec["mlp"]),
                                     self._partial(self.mlp_tp), sp)

        def cross_layer(x, cblk, cspec, g):
            gate = torch.tanh(self.use(cblk["gate"], cspec["gate"])).to(x.dtype)
            h, out = cross_attention(g, norm(x, cblk["attn_norm"], cspec["attn_norm"]),
                                     cblk["attn"], cspec["attn"])
            x = x + gate * self._combine(h, out, sp)
            h = norm(x, cblk["mlp_norm"], cspec["mlp_norm"])
            return x + gate * self._combine(self._mlp(h, cblk["mlp"], cspec["mlp"]),
                                            self._partial(self.mlp_tp), sp)

        def per_layer(stack: str):
            parts = {name: leaf.unbind(0) for name, leaf in _flat(params[stack])}
            lspecs = nest((name, P(*tuple(sp_)[1:])) for name, sp_ in _flat(specs[stack]))
            n = len(next(iter(parts.values())))
            return [nest((name, views[i]) for name, views in parts.items())
                    for i in range(n)], lspecs

        if mamba is None:
            def mamba(i, h, m, sm):
                return self.mamba(h, m, sm)[:2]

        def mamba_layer(x, blk, lspec, i):
            h, out = mamba(i, norm(x, blk["norm"], lspec["norm"]), blk["mamba"], lspec["mamba"])
            return x + self._combine(h, out, sp)

        ssm = cfg.family in ("ssm", "hybrid")
        blocks, lspecs = per_layer("blocks")
        cross, cspecs = per_layer("cross_blocks") if cfg.family == "vlm" else ([], None)
        shared, sspecs = per_layer("shared_attn") if cfg.family == "hybrid" else ([], None)
        groups = cfg.num_layers // cfg.attn_every if shared else 0
        aux: dict = {}
        for i, blk in enumerate(blocks):
            if shared and i % cfg.attn_every == 0 and i < groups * cfg.attn_every:
                x = layer(x, shared[0], sspecs, i // cfg.attn_every)   # outside remat
            body = mamba_layer if ssm else layer
            if remat:
                x = checkpoint(body, x, blk, lspecs, i, use_reentrant=False)
            else:
                x = body(x, blk, lspecs, i)
            if isinstance(x, tuple):
                x, layer_aux = x
                aux = {k: aux.get(k, 0.0) + v.float() for k, v in layer_aux.items()}
            if cross and (i + 1) % cfg.cross_attn_every == 0:
                g = i // cfg.cross_attn_every
                x = cross_layer(x, cross[g], cspecs, g)
        self.aux = {k: v / len(blocks) for k, v in aux.items()}
        if sp:
            x = lay.gather(x, 1, tp)
        return L.rms_norm(x, self.use(params["final_norm"], specs["final_norm"]), cfg.norm_eps)

    def head_weight(self) -> torch.Tensor:
        """The output projection's columns of this rank's vocab slice (or
        all of them), after :meth:`hidden`."""
        if self.cfg.tie_embeddings:
            if self.emb is None:   # a frame-input model with a tied head
                self.emb = self.use(self.params["embed"], self.specs["embed"],
                                    (0,) if self.vocab_tp else (), cast=True)
            return self.emb.T
        return self.use(self.params["lm_head"], self.specs["lm_head"],
                        (1,) if self.vocab_tp else (), cast=True)

    def image_kv(self, w: Dict, images: torch.Tensor, *, all_kv: bool = False):
        """A cross layer's k and v (B, n_img, KV_local, hd) of this rank's
        rows of the image embeddings, for the KV heads :meth:`flash_attention`
        reads (every KV head in ``all_kv`` or when ``w`` holds them all; in
        the ``q_sequence`` case all-gathered from each rank's columns)."""
        cfg = self.cfg
        wk, wv = w["wk"], w["wv"]
        if self.part.case == "q_heads" and not all_kv:
            lo, n = self.part.kv_heads
            kv = slice(lo * cfg.head_dim, (lo + n) * cfg.head_dim)
            wk, wv = wk[:, kv], wv[:, kv]
        b, n_img = images.shape[:2]
        proj = [images @ t.to(images.dtype) for t in (wk, wv)]
        if self.part.case == "q_sequence" and wk.shape[1] < cfg.num_kv_heads * cfg.head_dim:
            proj = [self.lay.gather(t, 2, self.tp) for t in proj]   # this rank's columns
        return tuple(t.reshape(b, n_img, -1, cfg.head_dim) for t in proj)

    def flash_attention(self, h: torch.Tensor, w: Dict, *, triangle: bool = False,
                        all_kv: bool = False, return_kv: bool = False,
                        kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Attention on this rank's heads (or, ``q_sequence``, its q rows)
        through the flash kernel: ``attention_block`` on its q heads and the
        KV heads they read (the weights of :meth:`attn_weights`).
        ``all_kv``: in the ``q_heads`` case compute every KV head (the cache
        holds them all) and map each query head to its own; ``return_kv``
        also returns the k, v computed; ``kv``: a cross layer's k and v
        (:meth:`image_kv`, non-causal).  The output's layout over TP is
        :meth:`out_layout`'s."""
        cfg, part = self.cfg, self.part
        n_kv, kv_index = part.kv_heads[1], part.kv_index
        gather_kv = None
        if part.case == "q_sequence" and w["wk"].shape[1] < n_kv * cfg.head_dim:
            def gather_kv(t):   # the whole k or v projection from the TP slices
                return self.lay.gather(t, 2, self.tp)
        if part.case == "q_heads":
            if all_kv:
                group = cfg.num_heads // cfg.num_kv_heads
                first = part.q_heads[0]
                n_kv = cfg.num_kv_heads
                kv_index = tuple((first + j) // group for j in range(part.q_heads[1]))
            elif kv is None:   # only the KV heads this rank's query heads read
                lo, n = part.kv_heads
                cols = slice(lo * cfg.head_dim, (lo + n) * cfg.head_dim)
                w = dict(w, wk=w["wk"][:, cols], wv=w["wv"][:, cols])
        return L.attention_block(
            h, w, num_heads=part.q_heads[1], num_kv_heads=n_kv, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
            kv_override=kv, triangle_schedule=triangle, kv_index=kv_index,
            return_kv=return_kv, q_rows=part.q_rows(h.shape[1]), gather_kv=gather_kv)


def sharded_hidden(cfg: ModelConfig, params: Dict, specs: Dict, batch: Dict[str, torch.Tensor],
                   *, triangle: bool = False) -> Tuple[torch.Tensor, _ShardedDecoder]:
    """The final hidden states (B, S, d) of this rank's rows of ``batch``
    (tokens or frame_embeds, and the vlm family's image_embeds), whole on
    every TP rank, and the :class:`_ShardedDecoder` that ran them (its
    :meth:`~_ShardedDecoder.head_weight` is the output projection's slice,
    its ``aux`` the moe family's metrics): the input, the layers with
    attention through the flash kernel on this rank's heads or q rows, and
    the final norm (:meth:`_ShardedDecoder.hidden`, which the serving
    functions of ``models/decode.py`` run with their own attention).  Self
    layers run under remat when ``cfg.remat`` and grad mode are on."""
    core = _ShardedDecoder(cfg, params, specs, "sharded_hidden")
    images = batch["image_embeds"].to(core.cdt) if cfg.family == "vlm" else None

    def attention(i, h, a, sa):
        return (core.flash_attention(h, core.attn_weights(a, sa), triangle=triangle),
                core.out_layout(h.shape[1]))

    def cross_attention(g, h, a, sa):
        w = core.attn_weights(a, sa)
        return (core.flash_attention(h, w, kv=core.image_kv(w, images)),
                core.out_layout(h.shape[1]))

    x = core.hidden(batch, attention, remat=cfg.remat and torch.is_grad_enabled(),
                    cross_attention=cross_attention)
    return x, core


def sharded_loss(cfg: ModelConfig, params: Dict, specs: Dict, batch: Dict[str, torch.Tensor],
                 *, count: torch.Tensor, triangle: bool = False,
                 metrics: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The next-token loss of every family on this rank's shards, inside
    :func:`~repro_torch.distributed.sharding.activation_sharding` over a
    ``DeviceMesh`` (the counterpart of :meth:`Model.loss` under the
    reference's ``jit_train_step``).

    ``params``: this rank's slices of the parameter tree, laid out by
    ``specs`` (:func:`param_specs`); ``batch``: this rank's rows (tokens or
    frame_embeds, image_embeds for the vlm family, labels, optional
    loss_mask), the same on every TP rank; ``count``: the number of counted
    tokens in the global batch.  The layers are :func:`sharded_hidden`'s;
    the flash kernels run on the local heads: head-parallel when the KV
    heads divide TP, q head-parallel with this rank's KV heads computed from
    the gathered wk / wv when only the q heads do, and this rank's q rows
    against the whole K and V (the kernels' query offset) when neither
    does; the Mamba2 layers on this rank's SSD heads (:meth:`_ShardedDecoder.mamba`).
    Vocab-parallel, the cross-entropy's max, sum of exponentials and
    gold logit are reduced over TP, as the reference constrains the logits
    to (batch, None, tp).

    Returns ``(objective, nll_sum)``: this rank's share of the loss (its
    rows' summed nll over ``count``, plus the moe family's ``aux_loss_coef *
    moe_aux_loss + router_z_coef * moe_z_loss`` over the number of batch
    ranks, all over the TP size, so that the shares of all ranks sum to the
    loss) and its rows' summed nll, detached.  ``metrics``, when given,
    receives the moe family's aux metrics of the global batch, detached."""
    x, core = sharded_hidden(cfg, params, specs, batch, triangle=triangle)
    logits = (x @ core.head_weight().to(x.dtype)).float()
    labels = batch["labels"].long()
    lay, tp = core.lay, core.tp
    if core.vocab_tp:
        peak = lay.all_reduce(logits.detach().amax(dim=-1), tp, op=torch.distributed.ReduceOp.MAX)
        logz = peak + torch.log(lay.psum(torch.exp(logits - peak[..., None]).sum(dim=-1), tp))
        local = labels - lay.coord[tp] * logits.shape[-1]
        inside = (local >= 0) & (local < logits.shape[-1])
        gold = torch.take_along_dim(logits, local.clamp(0, logits.shape[-1] - 1)[..., None],
                                    dim=-1)[..., 0]
        gold = lay.psum(torch.where(inside, gold, 0.0), tp)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    nll_sum = (nll * mask.float()).sum() if mask is not None else nll.sum()
    objective = nll_sum / count
    aux = core.aux
    if aux:
        ranks = lay.size(core.ctx.batch_axes) if core.ctx.batch_axes else 1
        objective = objective + (cfg.aux_loss_coef * aux["moe_aux_loss"]
                                 + cfg.router_z_coef * aux["moe_z_loss"]) / ranks
    if metrics is not None:
        metrics.update({k: v.detach() for k, v in aux.items()})
    return objective / core.ctx.tp_size, nll_sum.detach()
