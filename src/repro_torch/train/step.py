"""Train state and the train step (with microbatch gradient accumulation),
the port of ``repro.train.step``.

The state is ``{"step", "params", "opt"}``: the step as an int32 tensor,
the model's own parameter tensors in the reference's tree (switched to
``requires_grad``), and the optimizer state keyed by the same names.  The
step is ``(state, batch) -> (state, metrics)``; it writes the new parameters
and moments into the state's tensors (the reference donates its state) and
returns a new step counter.

Over a mesh (one process per device): :func:`state_specs` and
:func:`batch_specs` are the reference's specs, :func:`sharded_state` this
rank's slice of a train state, and :func:`sharded_train_step` the
counterpart of the reference's ``jit_train_step``: parameters and optimizer
state FSDP-sharded over the batch axes and tensor-parallel over
``"model"``, the batch sharded over the batch axes (every family).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.sharding import (P, activation_sharding, layout_of, mesh_sizes,
                                              shard_tree)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, param_specs, sharded_loss
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.tree import leaves, unflatten


def init_state(model: Model, opt_cfg: OptimizerConfig) -> Dict[str, Any]:
    """The train state over ``model``'s current parameters, which from now on
    require grad; a zero step and a fresh optimizer state."""
    params = model.param_tree()
    for p in leaves(params):
        p.requires_grad_(True)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
        "params": params,
        "opt": opt_lib.opt_init(opt_cfg, params),
    }


def state_shapes(model: Model, opt_cfg: OptimizerConfig) -> Dict[str, Any]:
    """The state's tree with shapes and dtypes only (``meta`` tensors)."""
    params = model.param_shapes()
    return {"step": torch.empty((), dtype=torch.int32, device="meta"), "params": params,
            "opt": opt_lib.opt_init(opt_cfg, params)}


def _check_params(model: Model, params) -> list:
    """The state's parameter leaves, which must be the model's own tensors
    (the step differentiates the model's forward)."""
    own = leaves(model.param_tree())
    got = leaves(params)
    if len(got) != len(own) or any(a is not b for a, b in zip(got, own)):
        raise ValueError("the state's params must be the model's own parameter tensors "
                         "(build the state with init_state(model, ...))")
    return got


def make_train_step(model: Model, opt_cfg: OptimizerConfig, *, microbatches: int = 1,
                    triangle: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    ``microbatches > 1`` accumulates float32 gradients over sequential
    slices of the batch's leading dim (the reference's ``lax.scan``), then
    scales the sums of loss, metrics and gradients by 1 / microbatches.
    Gradients are clipped by their global norm, then the optimizer updates;
    metrics gain ``grad_norm`` and ``lr``."""

    def grad(loss, flat):
        # A leaf the loss does not reach (a frame-input model's embed) gets
        # zeros, as under jax.grad, so the optimizer still decays it.
        return torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)

    def grads_of(flat, batch):
        if microbatches == 1:
            loss, metrics = model.loss(batch, triangle=triangle)
            return loss, metrics, grad(loss, flat)
        size = next(iter(batch.values())).shape[0] // microbatches
        loss_acc = metrics_acc = g_acc = None
        for i in range(microbatches):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, metrics = model.loss(mb, triangle=triangle)
            grads = grad(loss, flat)
            if g_acc is None:
                loss_acc = torch.zeros((), dtype=torch.float32, device=loss.device)
                metrics_acc = {k: torch.zeros_like(m) for k, m in metrics.items()}
                g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for p in flat]
            g_acc = [a + g for a, g in zip(g_acc, grads)]
            metrics_acc = {k: metrics_acc[k] + metrics[k].detach() for k in metrics_acc}
            loss_acc = loss_acc + loss.detach()
        inv = 1.0 / microbatches
        return (loss_acc * inv, {k: m * inv for k, m in metrics_acc.items()},
                [g * inv for g in g_acc])

    def train_step(state, batch):
        params = state["params"]
        flat = _check_params(model, params)
        loss, metrics, grads = grads_of(flat, batch)
        grad_tree, gnorm = opt_lib.clip_by_global_norm(unflatten(params, list(grads)),
                                                       opt_cfg.grad_clip)
        _, new_opt, lr = opt_lib.opt_update(opt_cfg, params, grad_tree, state["opt"],
                                            state["step"])
        metrics = {k: m.detach() for k, m in metrics.items()}
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return {"step": state["step"] + 1, "params": params, "opt": new_opt}, metrics

    return train_step


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------

def _cfg(model) -> ModelConfig:
    """A Model's config, or the config itself (the specs need shapes only)."""
    return model if isinstance(model, ModelConfig) else model.cfg


def state_specs(model, opt_cfg: OptimizerConfig, mesh,
                fsdp: Tuple[str, ...] = ("pod", "data"), tp: str = "model") -> Dict[str, Any]:
    """The train state's specs: the step replicated, the parameters'
    (``param_specs``) and the optimizer state's mirroring them.  ``model``:
    a Model or its config; ``mesh``: anything ``mesh_sizes`` reads."""
    pspecs = param_specs(_cfg(model), mesh, fsdp=fsdp, tp=tp)
    return {"step": P(), "params": pspecs, "opt": opt_lib.opt_state_specs(opt_cfg, pspecs)}


def batch_specs(model, mesh, batch_axes: Tuple[str, ...] = ("pod", "data")) -> Dict[str, P]:
    """The batch's specs: rows over the batch axes the mesh has."""
    cfg = _cfg(model)
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in batch_axes if a in sizes)
    specs: Dict[str, P] = {}
    if cfg.frame_inputs:
        specs["frame_embeds"] = P(axes, None, None)
    else:
        specs["tokens"] = P(axes, None)
    specs["labels"] = P(axes, None)
    if cfg.family == "vlm":
        specs["image_embeds"] = P(axes, None, None)
    return specs


def sharded_state(model: Model, opt_cfg: OptimizerConfig, mesh,
                  fsdp: Tuple[str, ...] = ("pod", "data"), tp: str = "model") -> Dict[str, Any]:
    """This rank's train state on ``mesh`` (a ``DeviceMesh``): its slices of
    ``model``'s parameters (copies, on the model's device, requiring grad),
    a zero step and a fresh optimizer state over the slices (so laid out by
    ``state_specs``).  The model holds the whole tree: its seeded init draws
    every parameter, as the reference's does before it shards."""
    params = shard_tree(model.param_tree(), param_specs(model.cfg, mesh, fsdp=fsdp, tp=tp), mesh)
    for p in leaves(params):
        p.requires_grad_(True)
    return {"step": torch.zeros((), dtype=torch.int32, device=model.device), "params": params,
            "opt": opt_lib.opt_init(opt_cfg, params)}


def sharded_train_step(model, opt_cfg: OptimizerConfig, mesh, *, microbatches: int = 1,
                       triangle: bool = False, fsdp: Tuple[str, ...] = ("pod", "data"),
                       tp: str = "model", seq_parallel: bool = False):
    """The port of the reference's ``jit_train_step``: returns ``(step,
    state_specs, batch_specs)``, ``step(state, batch) -> (state, metrics)``
    over this rank's slices of the state (:func:`sharded_state`) and of the
    batch (its rows over the batch axes, the same on every TP rank).

    ``model``: a Model or its config (every family); ``mesh``: a
    ``DeviceMesh`` over the default
    process group, every rank calling the step together.  The loss and its
    gradients are ``models.model.sharded_loss``'s (FSDP gathers and
    reduce-scatters, Megatron TP, the flash kernels on the local heads);
    ``microbatches > 1`` splits each rank's rows into that many slices (a
    microbatch is every rank's slice i: the reference's slices of the
    global batch hold other rows, the same mean when no ``loss_mask``
    weighs them) and accumulates float32 gradients.  Each gradient is then
    summed over the ranks that hold a replica of its parameter, clipped by
    the global norm (each shard counted once) and the optimizer updates the
    slices (Adafactor's means reduced over the sharded dims).  Metrics, the
    same on every rank: ``nll`` and ``loss`` (the global batch's mean; the
    moe family's loss adds its aux terms, and its ``moe_aux_loss``,
    ``moe_z_loss`` and ``moe_dropped`` are the global batch's), ``grad_norm``
    and ``lr``.  ``seq_parallel``: the residual's sequence
    sharded over ``tp`` between blocks (``activation_sharding``'s)."""
    cfg = _cfg(model)
    sspecs = state_specs(cfg, opt_cfg, mesh, fsdp=fsdp, tp=tp)
    bspecs = batch_specs(cfg, mesh, batch_axes=fsdp)
    pspecs = sspecs["params"]
    layout = layout_of(mesh)
    baxes = tuple(a for a in fsdp if a in layout.sizes)
    # Per leaf: the axes over which its parameter is replicated.
    replicas = [tuple(a for a in layout.names if a not in sp.axes()) for sp in leaves(pspecs)]

    def grads_of(params, batch):
        flat = leaves(params)
        rows = batch["labels"].shape[0]
        if rows % microbatches:
            raise ValueError(f"{rows} rows a rank do not split into {microbatches} microbatches")
        size = rows // microbatches
        share, acc, aux_acc = 0.0, None, {}
        for i in range(microbatches):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            mask = mb.get("loss_mask")
            local = (mask.float().sum() if mask is not None else
                     torch.tensor(float(mb["labels"].numel()), device=mb["labels"].device))
            count = torch.clamp(layout.all_reduce(local, baxes), min=1.0)
            aux = {}
            objective, nll_sum = sharded_loss(cfg, params, pspecs, mb, count=count,
                                              triangle=triangle, metrics=aux)
            # A leaf the loss does not reach (a frame-input model's embed)
            # gets zeros, as under jax.grad.
            grads = torch.autograd.grad(objective, flat, allow_unused=True,
                                        materialize_grads=True)
            share = share + nll_sum / count
            aux_acc = {k: aux_acc.get(k, 0.0) + v for k, v in aux.items()}
            if microbatches == 1:
                return share, aux_acc, list(grads)
            acc = [g.float() for g in grads] if acc is None else [
                a + g for a, g in zip(acc, grads)]
        inv = 1.0 / microbatches
        return share * inv, {k: v * inv for k, v in aux_acc.items()}, [g * inv for g in acc]

    def step(state, batch):
        with activation_sharding(mesh, batch_axes=fsdp, tp_axis=tp, seq_parallel=seq_parallel):
            params = state["params"]
            share, aux, grads = grads_of(params, batch)
            grads = [layout.all_reduce(g, axes) if layout.size(axes) > 1 else g
                     for g, axes in zip(grads, replicas)]
            zero = torch.zeros((), dtype=torch.float32, device=share.device)
            squares = sum((g.float().square().sum() if layout.first_replica(axes) else zero
                           for g, axes in zip(grads, replicas)), zero)
            gnorm = torch.sqrt(layout.all_reduce(squares, layout.names))
            scale = torch.clamp(opt_cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            grads = [(g.float() * scale).to(g.dtype) for g in grads]
            _, new_opt, lr = opt_lib.opt_update(opt_cfg, params, unflatten(params, grads),
                                                state["opt"], state["step"], specs=pspecs,
                                                layout=layout)
            nll = layout.all_reduce(share, baxes)
        loss = nll
        if aux:
            loss = nll + cfg.aux_loss_coef * aux["moe_aux_loss"] \
                + cfg.router_z_coef * aux["moe_z_loss"]
        metrics = {"nll": nll, "loss": loss, **aux, "grad_norm": gnorm, "lr": lr}
        return {"step": state["step"] + 1, "params": params, "opt": new_opt}, metrics

    return step, sspecs, bspecs
