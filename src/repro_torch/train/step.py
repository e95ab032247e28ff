"""Train state and the train step (with microbatch gradient accumulation),
the port of ``repro.train.step``.

The state is ``{"step", "params", "opt"}``: the step as an int32 tensor,
the model's own parameter tensors in the reference's tree (switched to
``requires_grad``), and the optimizer state keyed by the same names.  The
step is ``(state, batch) -> (state, metrics)``; it writes the new parameters
and moments into the state's tensors (the reference donates its state) and
returns a new step counter.  ``state_specs``, ``batch_specs`` and
``jit_train_step`` shard the step over a mesh and wait for multi-GPU
(ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.model import Model
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
