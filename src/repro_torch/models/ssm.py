"""Mamba2 / SSD (state-space duality) blocks: the chunked training scan and
the O(1) decode step.  The port of ``repro.models.ssm``.

The chunked SSD algorithm of arXiv:2405.21060 (ngroups = 1): within a chunk
the recurrence is a masked quadratic form; across chunks a small recurrence
carries the (H, P, N) states; decode is the exact single-step recurrence
against a carried (conv state, SSM state) cache.  The reference writes these
in jnp (no Pallas kernel stands behind them), so they are plain PyTorch here
too, with the reference's casts: the decays in float32, cast to the compute
type where they meet the products; ``dt``, its softplus and ``a`` in
float32; the states in the compute type.  The reference's four-operand
einsums are taken as pairwise products whose intermediates stay
O(B nc L^2 H) (nc chunks of L steps), and its ``lax.scan`` over chunks as a
loop over the nc chunk states.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm

# The decode cache's leaves of one Mamba2 layer, the reference's names.
CACHE_LEAVES = ("conv_x", "conv_b", "conv_c", "ssm")


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L) log-decays -> (..., L, L) with [i, j] = sum_{k=j+1..i} a_k
    for i >= j, -inf above the diagonal."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(l, device=a.device)
    return torch.where(idx[:, None] >= idx[None, :], diff, float("-inf"))


def ssd_scan(
    x: torch.Tensor,        # (B, S, H, P) — inputs, already scaled by dt
    a: torch.Tensor,        # (B, S, H)    — log decay per step (dt * A, <= 0)
    bmat: torch.Tensor,     # (B, S, N)
    cmat: torch.Tensor,     # (B, S, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B, S, H, P), final_state (B, H, P, N)).
    S must be a multiple of ``min(chunk, S)``, as in the reference."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD chunk {chunk}")
    nc = s // chunk

    xc = x.reshape(b, nc, chunk, h, p)
    ac = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)            # (B, H, nc, L)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)

    a_cs = torch.cumsum(ac, dim=-1)                                # (B, H, nc, L)
    ldec = torch.exp(_segsum(ac)).to(cc.dtype)                     # (B, H, nc, L, L)

    # 1) intra-chunk: (C B^T) masked by the decays, then times x.
    scores = cc @ bc.transpose(-1, -2)                             # (B, nc, L, L)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores[:, None] * ldec, xc)

    # 2) per-chunk output states: x decayed to the chunk's end, times B.
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)                # (B, H, nc, L)
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None].to(bc.dtype)
    states = torch.einsum("bcln,bclhp->bchpn", bc, xd)             # (B, nc, H, P, N)

    # 3) inter-chunk recurrence over the nc chunk states, keeping the state
    #    entering each chunk.
    chunk_decay = torch.exp(a_cs[..., -1])                         # (B, H, nc)
    carry = initial_state if initial_state is not None else x.new_zeros((b, h, p, n))
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None].to(carry.dtype) + states[:, c]
    prev_states = torch.stack(entering, dim=1)                     # (B, nc, H, P, N)

    # 4) inter-chunk contribution to the outputs.
    state_decay_out = torch.exp(a_cs).permute(0, 2, 3, 1)[..., None].to(cc.dtype)
    y_off = torch.einsum("bcln,bchpn->bclhp", cc, prev_states) * state_decay_out

    return (y_diag + y_off).reshape(b, s, h, p), carry


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x: (B, S, C); w: (K, C).  Returns (out, the
    new state): ``state`` ((B, K-1, C), the trailing inputs of the previous
    step; zeros when None) precedes x."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                                # (B, S+K-1, C)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :].to(x.dtype) for i in range(k))
    return out, xp[:, -(k - 1):, :]


def mamba2_block(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    *,
    d_state: int,
    head_dim: int,
    chunk: int,
    norm_eps: float,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    norm_mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (out (B, S, D), cache).  ``cache`` (the layer's
    ``CACHE_LEAVES``) makes it one decode step (S = 1); without it the block
    runs the chunked scan and returns the decode-ready cache (the trailing
    K-1 pre-activation conv inputs and the final SSM state).

    params: w_z, w_x (D, Din); w_b, w_c (D, N); w_dt (D, H); conv_x (K, Din);
    conv_b, conv_c (K, N); a_log, dt_bias, d_skip (H,); norm (Din,);
    w_out (Din, D).  On a tensor-parallel rank they are its heads' slices
    (Din and H local; B, C and their convs whole) and ``norm_mean`` makes
    the gated norm's mean square from the float32 sum of squares of the
    local channels (B, S, 1): the sum over every rank's channels over the
    whole width.
    """
    b, s, _ = x.shape
    d_in = params["w_out"].shape[0]
    h = d_in // head_dim

    z = x @ params["w_z"].to(x.dtype)
    xs_pre = x @ params["w_x"].to(x.dtype)
    b_pre = x @ params["w_b"].to(x.dtype)
    c_pre = x @ params["w_c"].to(x.dtype)
    dt_raw = x @ params["w_dt"].to(x.dtype)

    # The depthwise conv commutes with the channel split: each stream has its
    # own small conv and its own decode state.
    state = cache or {}
    xs, new_cx = _causal_conv(xs_pre, params["conv_x"], state.get("conv_x"))
    bmat, new_cb = _causal_conv(b_pre, params["conv_b"], state.get("conv_b"))
    cmat, new_cc = _causal_conv(c_pre, params["conv_c"], state.get("conv_c"))
    xs, bmat, cmat = F.silu(xs), F.silu(bmat), F.silu(cmat)

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())                        # (H,), negative
    log_decay = dt * a[None, None, :]                              # (B, S, H)

    xh = xs.reshape(b, s, h, head_dim)
    x_scaled = xh * dt[..., None].to(xh.dtype)

    if cache is None:
        y, final_state = ssd_scan(x_scaled, log_decay, bmat, cmat, chunk)
        k_w = params["conv_x"].shape[0]
        new_cache = {"conv_x": xs_pre[:, -(k_w - 1):, :], "conv_b": b_pre[:, -(k_w - 1):, :],
                     "conv_c": c_pre[:, -(k_w - 1):, :], "ssm": final_state}
    else:
        # The O(1) recurrence: state' = exp(dt a) state + dt x (outer) B.
        st = cache["ssm"]                                          # (B, H, P, N)
        dec = torch.exp(log_decay[:, 0, :])                        # (B, H)
        upd = x_scaled[:, 0, :, :, None] * bmat[:, 0, None, None, :]
        st = st * dec[..., None, None].to(st.dtype) + upd
        y = torch.einsum("bhpn,bn->bhp", st, cmat[:, 0])[:, None]  # (B, 1, H, P)
        new_cache = {"conv_x": new_cx, "conv_b": new_cb, "conv_c": new_cc, "ssm": st}

    y = y + xh * params["d_skip"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_in)
    if norm_mean is None:
        y = rms_norm(y, params["norm"], norm_eps)
    else:
        yf = y.float()
        var = norm_mean(torch.sum(yf * yf, dim=-1, keepdim=True))
        y = (yf * torch.rsqrt(var + norm_eps) * params["norm"].float()).to(y.dtype)
    y = y * F.silu(z)
    return y @ params["w_out"].to(x.dtype), new_cache
