"""Shared neural layers: RMSNorm, RoPE, GQA attention (train, prefill and
decode paths), SwiGLU MLP.  The port of ``repro.models.layers``.

Attention has two forms:

* :func:`flash_attention` — blockwise online-softmax attention, used by the
  forward pass, training and prefill.  On CUDA tensors its forward launches
  the hand-written kernel (``kernels/csrc/flash_attention.cu``); on CPU
  tensors it runs the plain version (``kernels.ref.flash_attention_ref``),
  the blockwise twin of the reference's ``_flash_fwd``.  When an input
  needs grad it is a ``torch.autograd.Function`` like the reference's
  custom VJP: the forward also returns lse and saves ``(q, k, v, out,
  lse)``, and the backward is ``ops.flash_attention_bwd``: on CUDA tensors
  the hand-written backward kernel (``kernels/csrc/flash_attention_bwd.cu``),
  on CPU tensors the plain version (``kernels.ref.flash_attention_bwd_ref``),
  the twin of the reference's jnp ``_flash_bwd_impl``.  Otherwise nothing is
  saved and no lse is asked for.
* :func:`decode_attention` — one-token attention against the KV cache,
  plain PyTorch as it is jnp in the reference.

The reference's sharding hooks (``constrain``, ``attn_partition``) live in
``repro_torch.distributed.sharding``, where they decide the sharded dense
block's layout (``models/model.py``); the block calls
:func:`attention_block` on its local heads (``kv_index`` maps them to the
KV heads it computed when the kernel's own GQA grouping does not).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF


# ---------------------------------------------------------------------------
# Norms / MLP
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g) * u) @ w_down.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                           # (D/2,)
    angles = positions[..., :, None, None].to(torch.float32) * freqs       # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the forward keeps (q, k, v, out,
    lse), the backward recomputes p from lse block by block."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, triangle, q_offset):
        out, lse = ops.flash_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                                       kv_chunk=kv_chunk, triangle=triangle, return_lse=True,
                                       q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.schedule = (causal, q_chunk, kv_chunk, triangle, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_chunk, kv_chunk, triangle, q_offset = ctx.schedule
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                             causal=causal, q_chunk=q_chunk,
                                             kv_chunk=kv_chunk, triangle=triangle,
                                             q_offset=q_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 512,
    triangle_schedule: bool = False,
    q_offset: int = 0,
) -> torch.Tensor:
    """Blockwise attention with a FlashAttention-style backward.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D); GQA via H % KV == 0.  The (S, S)
    score matrix is never materialised in either pass.  ``q_chunk``,
    ``kv_chunk`` and ``triangle_schedule`` keep the reference's signature;
    they shape the plain versions' blocks (the CUDA kernel has its own
    tiles, 128 q rows by 128 keys in the bf16 instance at head dims 64 and
    128, and always skips the blocks above the diagonal).  Under
    ``torch.no_grad()`` / ``inference_mode``, or when no input needs grad,
    this is the forward alone: nothing is saved and no lse is written.
    ``q_offset``: query row i sits at position ``q_offset + i`` for the
    causal mask, keys at 0 on (a slice of the q sequence against the whole
    K and V).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Flash.apply(q, k, v, causal, q_chunk, kv_chunk, triangle_schedule, q_offset)
    return ops.flash_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                               kv_chunk=kv_chunk, triangle=triangle_schedule, q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len: torch.Tensor,
    *,
    head_dim: Optional[int] = None,
    reduce_scores=None,
    first: int = 0,
    reduce_seq: Optional[Callable[[torch.Tensor, bool], torch.Tensor]] = None,
) -> torch.Tensor:
    """One-token attention. q: (B, 1, H, D); caches: (B, S, KV, D); the
    first ``cur_len[b]`` positions of row b are attended.

    A cache sharded along the head dim (the sharded decode's MHA fallback)
    passes its slice of q and of the caches, the whole ``head_dim`` (the
    scale's), and ``reduce_scores``, which sums the float32 partial scores
    over the ranks holding the other slices before the softmax; the output
    is then this slice of each head's output.

    A cache sharded along the sequence (the sharded decode's fallback for a
    batch too small for the batch axes) passes its slice, the position of
    its first row (``first``), and ``reduce_seq(t, maximum)``, which
    all-reduces ``t`` over the ranks holding the other slices (its maximum,
    or its sum): the flash-style pair combines each rank's max, sum of
    exponentials and unnormalised float32 output into every head's output."""
    b, _, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    g = h // kv
    scale = (head_dim or d) ** -0.5
    qh = q.reshape(b, kv, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qh, k_cache).float()
    if reduce_scores is not None:
        scores = reduce_scores(scores)
    scores = scores * scale
    pos = torch.arange(first, first + s, device=q.device)
    mask = pos[None, :] < cur_len[:, None]                                 # (B, S)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    if reduce_seq is not None:
        m = reduce_seq(m, True)
        p = torch.exp(scores - m)
        ol = reduce_seq(torch.cat([torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()),
                                   p.sum(dim=-1, keepdim=True)], dim=-1), False)
        out = (ol[..., :d] / ol[..., d:]).to(v_cache.dtype)
        return out.reshape(b, 1, h, d)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", (p / l).to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, d)


def attention_block(
    x: torch.Tensor,
    params: dict,
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    qk_norm: bool,
    norm_eps: float,
    positions: Optional[torch.Tensor] = None,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    q_chunk: int = 512,
    kv_chunk: int = 512,
    triangle_schedule: bool = False,
    kv_index: Optional[Tuple[int, ...]] = None,
    return_kv: bool = False,
    q_rows: Optional[Tuple[int, int]] = None,
    gather_kv: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Self-attention (or cross-attention when ``kv_override`` is given).

    params: wq (D, H*hd), wk (D, KV*hd), wv (D, KV*hd), wo (H*hd, D)
            [+ q_norm (hd,), k_norm (hd,) when qk_norm].
    ``kv_index``: query head i reads KV head ``kv_index[i]`` (k and v
    expanded to one head a query head); None: the kernel's GQA grouping.
    ``return_kv``: also return the k and v attended (B, S, KV, hd), after
    the qk-norm and RoPE and before ``kv_index``'s expansion (the prefill
    writes them into its cache).
    ``q_rows=(first, count)``: only those rows of ``x`` are queries (the
    ``q_sequence`` split), against the keys of every row of ``x`` (causal,
    ``first`` the kernel's query offset) or of ``kv_override``; the output
    has ``count`` rows.  ``gather_kv``: ``params`` hold a slice of wk's and
    wv's columns, and this makes the whole k and v projections from their
    slices' (the sharded layer's all-gather, before the qk-norm and RoPE).
    """
    b, s, _ = x.shape
    h, hd = num_heads, head_dim
    r0, n = q_rows if q_rows is not None else (0, s)
    if kv_override is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = project_qkv(x, params, num_heads=h, num_kv_heads=num_kv_heads,
                              head_dim=hd, qk_norm=qk_norm, norm_eps=norm_eps,
                              rope_theta=rope_theta, positions=positions, q_rows=q_rows,
                              gather_kv=gather_kv)
        causal = True
    else:
        q = (x.narrow(1, r0, n) @ params["wq"].to(x.dtype)).reshape(b, n, h, hd)
        k, v = kv_override
        if qk_norm:
            q = rms_norm(q, params["q_norm"], norm_eps)
            k = rms_norm(k, params["k_norm"], norm_eps)
        causal = False
    cached = (k, v)
    if kv_index is not None:
        index = torch.tensor(kv_index, device=k.device)
        k, v = k.index_select(2, index), v.index_select(2, index)
    out = flash_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                          triangle_schedule=triangle_schedule, q_offset=r0 if causal else 0)
    out = out.reshape(b, n, h * hd) @ params["wo"].to(x.dtype)
    return (out, cached) if return_kv else out


def project_qkv(x: torch.Tensor, params: dict, *, num_heads: int, num_kv_heads: int,
                head_dim: int, qk_norm: bool, norm_eps: float, rope_theta: float,
                positions: torch.Tensor, q_rows: Optional[Tuple[int, int]] = None,
                gather_kv: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, S, H, hd), k and v (B, S, KV, hd) of the normed input ``x``:
    projected, qk-normed and rotated to ``positions`` (broadcastable to
    (B, S)).  ``q_rows=(first, count)``: q of those rows only (B, count, H,
    hd), rotated to their positions.  ``gather_kv``: as
    :func:`attention_block` takes it."""
    b, s, _ = x.shape
    xq, pq = x, positions
    if q_rows is not None:
        xq, pq = x.narrow(1, *q_rows), positions.narrow(-1, *q_rows)
    q = (xq @ params["wq"].to(x.dtype)).reshape(b, xq.shape[1], num_heads, head_dim)
    k, v = (x @ params["wk"].to(x.dtype)), (x @ params["wv"].to(x.dtype))
    if gather_kv is not None:
        k, v = gather_kv(k), gather_kv(v)
    k = k.reshape(b, s, num_kv_heads, head_dim)
    v = v.reshape(b, s, num_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = rms_norm(k, params["k_norm"], norm_eps)
    return apply_rope(q, pq, rope_theta), apply_rope(k, positions, rope_theta), v
