"""Serving path of the dense, ssm and hybrid families: the KV / SSM-state
cache, prefill and one-token decode.  The port of
``repro.models.decode.DecodeEngine``.

The cache is a dict of the reference's leaves, in the compute type: ``"cur"``
int32 (B,) positions filled so far; dense: ``"k"`` and ``"v"`` (L, B,
max_len, KV, hd); ssm: each Mamba2 layer's ``"conv_x"`` (L, B, K-1, Din),
``"conv_b"`` and ``"conv_c"`` (L, B, K-1, N) and ``"ssm"`` (L, B, H, P, N);
hybrid: those, and ``"shared"`` ``{"k", "v"}`` of the shared attention
block, one slot a group (num_layers // attn_every).  Unlike the reference,
which returns a new cache, :meth:`DecodeEngine.decode_step` writes the new
token's K/V and states into the cache it is given and advances ``"cur"`` in
place (the returned cache is the same dict), so a step never copies the
cache.  Prefill attention runs the flash kernel on the card
(``layers.flash_attention``); decode attention and the SSM recurrences are
plain PyTorch, as they are jnp in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, dtype_of

Cache = Dict[str, torch.Tensor]


class DecodeEngine:
    """Prefill and greedy-decode bodies over a :class:`Model`.  Methods take
    the model where the reference takes its parameter tree."""

    def __init__(self, model: Model):
        self.model = model

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    def init_cache(self, batch: int, max_len: int) -> Cache:
        cfg = self.cfg
        dev, cdt = self.model.device, dtype_of(cfg.dtype)

        def zeros(*shape):
            return torch.zeros(shape, dtype=cdt, device=dev)

        def kv(n_layers):
            shape = (n_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            return {"k": zeros(*shape), "v": zeros(*shape)}

        nl, k = cfg.num_layers, cfg.ssm_conv
        cache: Cache = {"cur": torch.zeros((batch,), dtype=torch.int32, device=dev)}
        if cfg.family == "dense":
            cache.update(kv(nl))
        else:
            cache.update(conv_x=zeros(nl, batch, k - 1, cfg.ssm_inner),
                         conv_b=zeros(nl, batch, k - 1, cfg.ssm_state),
                         conv_c=zeros(nl, batch, k - 1, cfg.ssm_state),
                         ssm=zeros(nl, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
            if cfg.family == "hybrid":
                cache["shared"] = kv(nl // cfg.attn_every)
        return cache

    def _qkv(self, h: torch.Tensor, blk: Dict, positions: torch.Tensor):
        """q (B, S, H, hd), k and v (B, S, KV, hd) of normed input ``h``,
        qk-normed and rotated to ``positions``."""
        cfg = self.cfg
        b, s = h.shape[:2]
        attn = blk["attn"]
        q = (h @ attn["wq"].to(h.dtype)).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = (h @ attn["wk"].to(h.dtype)).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = (h @ attn["wv"].to(h.dtype)).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = L.rms_norm(q, attn["q_norm"], cfg.norm_eps)
            k = L.rms_norm(k, attn["k_norm"], cfg.norm_eps)
        return (L.apply_rope(q, positions, cfg.rope_theta),
                L.apply_rope(k, positions, cfg.rope_theta), v)

    def _attn_decode(self, x: torch.Tensor, blk: Dict, kc: torch.Tensor,
                     vc: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
        """x: (B, 1, D); kc/vc: this layer's (B, S, KV, hd) cache, updated in
        place at position ``cur``.  Returns x plus the attention output."""
        cfg = self.cfg
        b = x.shape[0]
        h = L.rms_norm(x, blk["attn_norm"], cfg.norm_eps)
        q, k, v = self._qkv(h, blk, cur[:, None])
        rows = torch.arange(b, device=x.device)
        kc[rows, cur] = k[:, 0].to(kc.dtype)
        vc[rows, cur] = v[:, 0].to(vc.dtype)
        out = L.decode_attention(q, kc, vc, cur + 1).reshape(b, 1, cfg.attn_dim)
        return x + out @ blk["attn"]["wo"].to(x.dtype)

    def _mamba(self, x: torch.Tensor, blk: Dict, cache: Cache, i: int,
               step: bool) -> torch.Tensor:
        """Layer i's Mamba2 block: one decode step against the cache
        (``step``) or the prefill's scan; either way its states are written
        into layer i's cache slots, right-aligned (a prompt shorter than K-1
        leaves the leading conv rows zero).  Returns x plus the block's
        output."""
        cfg = self.cfg
        h, new = ssm_lib.mamba2_block(
            L.rms_norm(x, blk["norm"], cfg.norm_eps), blk["mamba"], d_state=cfg.ssm_state,
            head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps,
            cache={name: cache[name][i] for name in ssm_lib.CACHE_LEAVES} if step else None)
        for name in ssm_lib.CACHE_LEAVES:
            dst = cache[name][i]
            dst[:, dst.shape[1] - new[name].shape[1]:].copy_(new[name])
        return x + h

    def decode_step(self, model: Model, cache: Cache,
                    batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Cache]:
        """batch: tokens (B, 1).  Returns (logits (B, 1, V), cache), the
        cache updated in place: this token's K/V written at ``cur``, the
        SSM states advanced, and ``cur`` advanced by one."""
        cur = cache["cur"]
        x = model.embed_tokens(batch["tokens"])
        fam = self.cfg.family
        shared = model.shared_layer() if fam == "hybrid" else None
        for i, blk in enumerate(model.layers()):
            if fam == "dense":
                x = self._attn_decode(x, blk, cache["k"][i], cache["v"][i], cur)
                x = model.mlp(x, blk)
                continue
            if shared is not None and model.shared_before(i):
                g = i // self.cfg.attn_every
                x = self._attn_decode(x, shared, cache["shared"]["k"][g],
                                      cache["shared"]["v"][g], cur)
                x = model.mlp(x, shared)
            x = self._mamba(x, blk, cache, i, step=True)
        logits = model.head(x)
        cache["cur"] = cur + 1
        return logits, cache

    def prefill(self, model: Model, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None,
                last_only: bool = False) -> Tuple[torch.Tensor, Cache]:
        """Runs the full-sequence forward and returns (logits, filled cache).

        The cache is allocated at ``max_len`` (>= S) and filled for the first
        S positions.  ``last_only`` returns logits for the final position only
        (B, 1, V) — what serving needs; it avoids the (B, S, V) tensor.
        """
        cfg = self.cfg
        x = model.embed_tokens(batch["tokens"])
        b, s = x.shape[:2]
        max_len = max_len or s
        if max_len < s:
            raise ValueError(f"max_len {max_len} is shorter than the prompt ({s})")
        cache = self.init_cache(b, max_len)
        cache["cur"].fill_(s)
        positions = torch.arange(s, device=x.device)[None, :]

        def attention(x, blk, kc, vc):
            h = L.rms_norm(x, blk["attn_norm"], cfg.norm_eps)
            q, k, v = self._qkv(h, blk, positions)
            out = L.flash_attention(q, k, v, causal=True)
            kc[:, :s] = k
            vc[:, :s] = v
            x = x + out.reshape(b, s, cfg.attn_dim) @ blk["attn"]["wo"].to(x.dtype)
            return model.mlp(x, blk)

        shared = model.shared_layer() if cfg.family == "hybrid" else None
        for i, blk in enumerate(model.layers()):
            if cfg.family == "dense":
                x = attention(x, blk, cache["k"][i], cache["v"][i])
                continue
            if shared is not None and model.shared_before(i):
                g = i // cfg.attn_every
                x = attention(x, shared, cache["shared"]["k"][g], cache["shared"]["v"][g])
            x = self._mamba(x, blk, cache, i, step=False)
        if last_only:
            x = x[:, -1:, :]
        return model.head(x), cache
