"""Top-k routed Mixture-of-Experts with capacity-based dispatch (GShard /
Switch style).  The port of ``repro.models.moe``.

Tokens are routed in groups of ``group_size`` consecutive positions of a
sequence, as in the reference: the router in float32 and its softmax, the
top-k with the kept gates renormalised, a capacity of ``max(int(cf * t * k
/ E), 4)`` slots an expert a group, and each (token, choice) given the slot
of an exclusive cumsum over the group's token-major (t * k) flattening, so
the same choices overflow and are dropped.  The reference dispatches with
(G, t, E, C) one-hots and runs every expert over its C slots; here each
expert's kept choices are gathered, run through the expert's SwiGLU and
scattered back, which gives the same numbers without the empty slots' work
(at ``capacity_factor = E / k`` the one-hot form would run every expert
over every token).  The combine weights are cast to the compute type before
they meet the experts' outputs, as the reference's ``combine.astype`` does,
and the k weighted outputs of a token are summed in float32 (the
reference's combine einsum, whose other terms are zeros).  The reference
writes all of this in jnp, so it is plain PyTorch here too.

Expert parallelism (the reference puts E over ``"model"``): with
``experts=(first, count)`` the block holds only those experts' leaves and
runs only their kept choices; every rank routes every token of its rows
(the routing, capacity, slots and drops are the whole block's), and the
float32 partial outputs of the ranks sum to the block's.  ``reduce``
averages the routing statistics over the ranks that hold the batch's other
rows before the aux losses are formed, so they are the global batch's.  On
``meta`` tensors (the dry run) each local expert runs over its capacity's
slots, the reference's static expert shapes.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class Routing(NamedTuple):
    """One block's routing of its groups (:func:`route`): ``logits`` and
    ``probs`` (G, t, E) in float32, ``onehot`` (G, t, k, E), ``choice``,
    ``gates`` and ``keep`` (G, t * k) over the token-major flattening of
    the top-k choices (the expert, its renormalised gate, whether its slot
    is within ``capacity``)."""
    logits: torch.Tensor
    probs: torch.Tensor
    onehot: torch.Tensor
    choice: torch.Tensor
    gates: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(xg: torch.Tensor, router: torch.Tensor, *, num_experts: int, k: int,
          capacity_factor: float) -> Routing:
    """The routing of ``xg`` (G, t, D) groups: the router in float32 and
    its softmax, the top-k with the kept gates renormalised by max(sum,
    1e-9), a capacity of ``max(int(cf * t * k / E), 4)`` slots an expert a
    group, and each (token, choice) the slot of an exclusive cumsum over
    the group's token-major flattening, kept when it is within capacity.
    The one copy of the routing: every expert-parallel rank runs it on the
    same rows."""
    e = num_experts
    g_dim, t = xg.shape[:2]
    logits = xg.float() @ router.float()                             # (G, t, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)             # (G, t, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    capacity = max(int(capacity_factor * t * k / e), 4)
    onehot = F.one_hot(expert_idx, e)                                # (G, t, k, E)
    flat = onehot.reshape(g_dim, t * k, e)
    choice = expert_idx.reshape(g_dim, t * k)
    # Slot of each (token, choice) within its expert's capacity.
    slot = (flat.cumsum(dim=1) - flat).gather(-1, choice[..., None])[..., 0]
    return Routing(logits, probs, onehot, choice, gate_vals.reshape(g_dim, t * k),
                   slot < capacity, capacity)


def moe_block(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    *,
    num_experts: int,
    k: int,
    capacity_factor: float = 1.25,
    group_size: int = 1024,
    experts: Optional[Tuple[int, int]] = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out (B, S, D), aux metrics).

    params: router (D, E); w_gate / w_up (E, D, F); w_down (E, F, D).  The
    aux metrics are float32 scalars: ``moe_aux_loss`` (load balance),
    ``moe_z_loss`` (router z-loss) and ``moe_dropped`` (the share of choices
    over capacity).

    ``experts=(first, count)``: the expert leaves hold experts first ..
    first + count - 1 only (the router all E), and ``out`` is their part of
    the block's output, in float32 (the parts of all ranks sum to it).
    ``reduce``: a mean over the data-parallel ranks (with its adjoint),
    applied to the routing statistics."""
    b, s, d = x.shape
    e = num_experts
    gs = min(group_size, s)
    assert s % gs == 0, (s, gs)
    xg = x.reshape(b * (s // gs), gs, d)
    g_dim, t = xg.shape[:2]

    r = route(xg, params["router"], num_experts=e, k=k, capacity_factor=capacity_factor)
    choice, keep, capacity = r.choice, r.keep, r.capacity

    cdt = x.dtype
    first, count = experts if experts is not None else (0, e)
    # The combine weights in the compute type, zero where a choice is dropped.
    weight = torch.where(keep, r.gates, 0.0).to(cdt).reshape(-1)

    def expert(i, xe):   # local expert i's SwiGLU
        h = F.silu(xe @ params["w_gate"][i].to(cdt)) * (xe @ params["w_up"][i].to(cdt))
        return h @ params["w_down"][i].to(cdt)

    n = g_dim * t * k
    xf = xg.reshape(g_dim * t, d)
    contrib = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        for i in range(count):
            expert(i, xf.new_empty((g_dim * capacity, d)))
    else:
        # This block's experts over their kept choices, in slot order: one
        # sort of the choices by expert (others' and dropped ones last) and
        # one read of this block's counts.
        local = keep & (choice >= first) & (choice < first + count)
        bucket = torch.where(local, choice - first, count).reshape(-1)
        order = torch.argsort(bucket, stable=True)
        counts = torch.bincount(bucket, minlength=count + 1)[:count].tolist()
        token = order // k                                           # the choice's token
        outs, start = [], 0
        for i, c in enumerate(counts):
            if c:
                outs.append(expert(i, xf[token[start:start + c]]))
            start += c
        kept = order[:start]
        if outs:
            y = torch.cat(outs) if len(outs) > 1 else outs[0]
            contrib = contrib.index_copy(0, kept, y.float() * weight[kept, None].float())
    out = contrib.reshape(g_dim * t, k, d).sum(dim=1)
    if experts is None:
        out = out.to(cdt)

    # ---- aux losses (fp32), from the whole routing ----
    mean = reduce or (lambda v: v)
    me = mean(r.probs.mean(dim=(0, 1)))                              # (E,)
    ce = mean(r.onehot.sum(dim=2).float().mean(dim=(0, 1)))          # (E,) token fraction * k
    aux_loss = e * torch.sum(me * ce) / k
    z_loss = mean(torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2))
    dropped = 1.0 - mean(keep.sum().float() / (g_dim * t * k))

    aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss, "moe_dropped": dropped}
    return out.reshape(b, s, d), aux
