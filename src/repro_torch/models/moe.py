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
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def moe_block(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    *,
    num_experts: int,
    k: int,
    capacity_factor: float = 1.25,
    group_size: int = 1024,
) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out (B, S, D), aux metrics).

    params: router (D, E); w_gate / w_up (E, D, F); w_down (E, F, D).  The
    aux metrics are float32 scalars: ``moe_aux_loss`` (load balance),
    ``moe_z_loss`` (router z-loss) and ``moe_dropped`` (the share of choices
    over capacity)."""
    b, s, d = x.shape
    e = num_experts
    gs = min(group_size, s)
    assert s % gs == 0, (s, gs)
    xg = x.reshape(b * (s // gs), gs, d)
    g_dim, t = xg.shape[:2]

    router_logits = xg.float() @ params["router"].float()            # (G, t, E)
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)             # (G, t, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    capacity = max(int(capacity_factor * t * k / e), 4)
    onehot = F.one_hot(expert_idx, e)                                # (G, t, k, E)
    flat = onehot.reshape(g_dim, t * k, e)
    choice = expert_idx.reshape(g_dim, t * k)
    # Slot of each (token, choice) within its expert's capacity.
    slot = (flat.cumsum(dim=1) - flat).gather(-1, choice[..., None])[..., 0]
    keep = slot < capacity                                           # (G, t * k)

    cdt = x.dtype
    # The combine weights in the compute type, zero where a choice is dropped.
    weight = torch.where(keep, gate_vals.reshape(g_dim, t * k), 0.0).to(cdt).reshape(-1)

    # Each expert over its kept choices, in slot order: one sort of the
    # choices by expert (dropped ones last) and one read of the counts.
    n = g_dim * t * k
    bucket = torch.where(keep, choice, e).reshape(-1)
    order = torch.argsort(bucket, stable=True)
    counts = torch.bincount(bucket, minlength=e + 1).tolist()
    xf = xg.reshape(g_dim * t, d)
    token = order // k                                               # the choice's token
    outs, start = [], 0
    for i, c in enumerate(counts[:e]):
        if c:
            xe = xf[token[start:start + c]]
            h = F.silu(xe @ params["w_gate"][i].to(cdt)) * (xe @ params["w_up"][i].to(cdt))
            outs.append(h @ params["w_down"][i].to(cdt))
        start += c
    kept = order[:start]
    contrib = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    if outs:
        y = torch.cat(outs) if len(outs) > 1 else outs[0]
        contrib = contrib.index_copy(0, kept, y.float() * weight[kept, None].float())
    out = contrib.reshape(g_dim * t, k, d).sum(dim=1).to(cdt)

    # ---- aux losses (fp32) ----
    me = probs.mean(dim=(0, 1))                                      # (E,)
    ce = onehot.sum(dim=2).float().mean(dim=(0, 1))                  # (E,) token fraction * k
    aux_loss = e * torch.sum(me * ce) / k
    z_loss = torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2)
    dropped = 1.0 - keep.sum().float() / (g_dim * t * k)

    aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss, "moe_dropped": dropped}
    return out.reshape(b, s, d), aux
