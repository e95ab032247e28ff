"""Int8 gradient compression with stochastic rounding, the port of
``repro.train.compress``: the blockwise quantise / dequantise pair, and
``compressed_pmean``, the mean of a gradient tree over a process group with
an int8 payload (the reference's cross-pod reduction: the ``pod`` axis
crosses the slow network, so its all-reduce is quantised 4x).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

BLOCK = 256


def quantize_int8(x: torch.Tensor, generator: torch.Generator):
    """Blockwise int8 quantisation with stochastic rounding.

    Returns (q int8[N], scale float32[ceil(N/BLOCK)]): each block of BLOCK
    values scaled by its largest magnitude / 127, then floor(y + u) with u
    uniform in [0, 1) from ``generator`` (on x's device).  Unbiased:
    E[dequant] = x."""
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1) / 127.0, min=1e-30)
    y = blocks / scale[:, None]
    noise = torch.rand(y.shape, generator=generator, device=y.device)
    q = torch.floor(y + noise).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    y = q.float() * scale[:, None]
    return y.reshape(-1)[:math.prod(shape)].reshape(shape).to(dtype)


def compressed_pmean(tree, group, generator: torch.Generator):
    """Mean of a tree of tensors over the ranks of ``group`` (a process
    group; None for the default one) with an int8 payload, every rank
    calling it with its own tree of the same shapes.

    Two phases with a shared scale, as the reference's: each block's largest
    magnitude is all-reduced with MAX (a small payload), so every rank
    quantises against the same scale; the stochastically rounded int8 blocks
    (noise from ``generator``, on the tensors' device, drawn leaf by leaf)
    are summed as int32, dequantised once and divided by the group's size.
    Unbiased (E[result] = the true mean).  Under gloo the payloads cross
    through host copies.  Returns a tree of the same structure and types,
    the same on every rank."""
    from repro_torch.distributed.sharding import _via_host
    from repro_torch.train.tree import leaves, unflatten

    n_dev = dist.get_world_size(group)
    host = _via_host(group)

    def reduce(t, op):
        buf = t.cpu() if host else t
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(t.device)

    out = []
    for leaf in leaves(tree):
        flat = leaf.float().reshape(-1)
        pad = (-flat.shape[0]) % BLOCK
        blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
        shared_max = reduce(blocks.abs().amax(dim=1), dist.ReduceOp.MAX)
        scale = torch.clamp(shared_max / 127.0, min=1e-30)
        y = blocks / scale[:, None]
        noise = torch.rand(y.shape, generator=generator, device=y.device)
        q = torch.floor(y + noise).clamp(-127, 127).to(torch.int8)
        qsum = reduce(q.to(torch.int32), dist.ReduceOp.SUM)
        deq = (qsum.float() * scale[:, None]).reshape(-1)[:flat.shape[0]].reshape(leaf.shape)
        out.append((deq / n_dev).to(leaf.dtype))
    return unflatten(tree, out)
