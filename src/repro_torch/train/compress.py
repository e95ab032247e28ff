"""Int8 gradient compression with stochastic rounding, the port of
``repro.train.compress``: the blockwise quantise / dequantise pair.

``compressed_pmean`` (the cross-pod reduction itself) needs a process group
and waits for multi-GPU (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import math

import torch

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
