"""Optimizers: AdamW (default) and Adafactor, the port of
``repro.train.optimizer``.

They act on nested dicts of tensors (the reference's pytrees) with the
reference's float32 arithmetic: the step as float32, ``b1 ** t`` as a
float32 power, decoupled weight decay on tensors of two or more dims only.
``adamw_update`` and ``adafactor_update`` write the new parameters and
moments into the given tensors (the reference donates its state to the jitted
step) and return them.  ``opt_state_specs`` shards the state over a mesh and
waits for multi-GPU (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.train.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _f32(step, device=None) -> torch.Tensor:
    return torch.as_tensor(step, device=device).to(torch.float32)


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, as a float32 tensor."""
    step = _f32(step)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * torch.where(step < cfg.warmup_steps, warm, decay)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state, step):
    lr = lr_schedule(cfg, step)
    t = _f32(step) + 1.0
    c1 = 1.0 - torch.pow(cfg.b1, t)
    c2 = 1.0 - torch.pow(cfg.b2, t)

    def upd(p, g, mu, nu):
        g = g.float()
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
        mhat = mu / c1
        nhat = nu / c2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    tree_map(upd, params, grads, state["mu"], state["nu"])
    return params, state, lr


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------

def adafactor_init(params):
    def factored(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
        if p.dim() >= 2:
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    return {"v": tree_map(factored, params)}


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, params, grads, state, step):
    lr = lr_schedule(cfg, step)
    t = _f32(step) + 1.0
    beta2 = 1.0 - torch.pow(t, -0.8)

    def upd(p, g, v):
        g = g.float()
        g2 = g * g + 1e-30
        if p.dim() >= 2:
            v["vr"].copy_(beta2 * v["vr"] + (1 - beta2) * torch.mean(g2, dim=-1))
            v["vc"].copy_(beta2 * v["vc"] + (1 - beta2) * torch.mean(g2, dim=-2))
            vr, vc = v["vr"], v["vc"]
            denom = (vr[..., None] * vc[..., None, :]) / torch.clamp(
                torch.mean(vr, dim=-1, keepdim=True)[..., None], min=1e-30)
            update = g / torch.sqrt(denom + 1e-30)
        else:
            v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
            update = g / torch.sqrt(v["v"] + 1e-30)
        # Update clipping (RMS <= 1) per Adafactor.
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        if p.dim() >= 2:
            update = update + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * update)

    # A factored moment is a dict of its own: walk the parameters' paths.
    def walk(p, g, v):
        if isinstance(p, dict):
            for key in p:
                walk(p[key], g[key], v[key])
        else:
            upd(p, g, v)

    walk(params, grads, state["v"])
    return params, state, lr


def opt_init(cfg: OptimizerConfig, params):
    return {"adamw": adamw_init, "adafactor": adafactor_init}[cfg.name](params)


def opt_update(cfg: OptimizerConfig, params, grads, state, step):
    fn = {"adamw": adamw_update, "adafactor": adafactor_update}[cfg.name]
    return fn(cfg, params, grads, state, step)
