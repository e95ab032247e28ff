"""Serving path of the six families: the KV / SSM-state cache, prefill and
one-token decode.  The port of ``repro.models.decode.DecodeEngine``.

The cache is a dict of the reference's leaves, in the compute type: ``"cur"``
int32 (B,) positions filled so far; dense, moe and audio: ``"k"`` and
``"v"`` (L, B, max_len, KV, hd); vlm: those of its self layers, and
``"img_k"`` / ``"img_v"`` (n_cross, B, n_img, KV, hd), each cross layer's
K and V of the image embeddings, filled by the prefill; ssm: each Mamba2
layer's ``"conv_x"`` (L, B, K-1, Din), ``"conv_b"`` and ``"conv_c"`` (L, B,
K-1, N) and ``"ssm"`` (L, B, H, P, N); hybrid: those, and ``"shared"``
``{"k", "v"}`` of the shared attention block, one slot a group (num_layers
// attn_every).  A frame-input model (audio) takes ``frame_embeds`` where
the others take ``tokens``; the vlm prefill takes ``image_embeds``, its
decode reads them from the cache.  The moe family routes a decode step's
tokens as groups of one (capacity 4, so nothing is dropped), as the
reference does.  Unlike the reference,
which returns a new cache, :meth:`DecodeEngine.decode_step` writes the new
token's K/V and states into the cache it is given and advances ``"cur"`` in
place (the returned cache is the same dict), so a step never copies the
cache.  Prefill attention runs the flash kernel on the card
(``layers.flash_attention``); decode attention and the SSM recurrences are
plain PyTorch, as they are jnp in the reference.  The vlm prefill's
cross-attention is the flash kernel too, non-causal over the image tokens;
its decode attends to the whole image cache.  Over a mesh
:func:`sharded_prefill` and :func:`sharded_decode_step` serve every family
from a cache shard laid out by :func:`cache_specs`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, _ShardedDecoder, dtype_of, num_cross_layers

Cache = Dict[str, torch.Tensor]


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """The shape of each leaf of :meth:`DecodeEngine.init_cache` (nested as
    the cache is), without allocating it."""
    nl, k = cfg.num_layers, cfg.ssm_conv

    def kv(n_layers):
        shape = (n_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": shape, "v": shape}

    shapes: Dict = {"cur": (batch,)}
    if cfg.family in ("dense", "moe", "audio"):
        shapes.update(kv(nl))
    elif cfg.family == "vlm":
        n_cross = num_cross_layers(cfg)
        shapes.update(kv(nl - n_cross))
        img = (n_cross, batch, cfg.num_image_tokens, cfg.num_kv_heads, cfg.head_dim)
        shapes.update(img_k=img, img_v=img)
    else:
        shapes.update(conv_x=(nl, batch, k - 1, cfg.ssm_inner),
                      conv_b=(nl, batch, k - 1, cfg.ssm_state),
                      conv_c=(nl, batch, k - 1, cfg.ssm_state),
                      ssm=(nl, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
        if cfg.family == "hybrid":
            shapes["shared"] = kv(nl // cfg.attn_every)
    return shapes


def cache_specs(cfg: ModelConfig, mesh, batch: int, fsdp: Tuple[str, ...] = ("pod", "data"),
                tp: str = "model") -> Dict:
    """The reference's ``DecodeEngine.cache_specs``: the batch dim over the
    FSDP axes when ``batch`` divides them, else (tiny batches, long_500k)
    the sequence dim over the non-pod FSDP axes; KV heads over TP (the
    hybrid's ``shared`` K/V too), or the head dim when the KV heads do not
    divide (the MHA fallback); the conv states' channels over TP (``conv_b``
    and ``conv_c`` on N, although their weights are replicated) and the SSM
    heads over TP, each where it divides.  :func:`sharded_prefill` and
    :func:`sharded_decode_step` serve all six families (dense, moe, ssm,
    hybrid, vlm, audio) from a cache so laid out."""
    from repro_torch.distributed.sharding import P, axes_size, mesh_sizes

    sizes = mesh_sizes(mesh)
    fsdp = tuple(a for a in fsdp if a in sizes)
    fsdp_size = axes_size(sizes, fsdp) if fsdp else 1
    tp_size = sizes[tp] if tp in sizes else 1
    batch_ax = fsdp if fsdp and batch % fsdp_size == 0 else None
    # Sequence-parallel fallback for tiny batches (long_500k).
    seq_ax = None if batch_ax is not None else tuple(a for a in fsdp if a != "pod") or None

    def ax_t(dim):
        return tp if tp_size > 1 and dim % tp_size == 0 else None

    def spec_for(name, shape):
        if name == "cur":
            return P(None)
        if name in ("k", "v"):  # (L, B, S, KV, hd)
            sax = seq_ax if seq_ax and shape[2] % fsdp_size == 0 else None
            kv_ax = ax_t(shape[3])
            hd_ax = ax_t(shape[4]) if kv_ax is None else None
            return P(None, batch_ax, sax, kv_ax, hd_ax)
        if name in ("img_k", "img_v"):
            kv_ax = ax_t(shape[3])
            hd_ax = ax_t(shape[4]) if kv_ax is None else None
            return P(None, batch_ax, None, kv_ax, hd_ax)
        if name in ("conv_x", "conv_b", "conv_c"):
            return P(None, batch_ax, None, ax_t(shape[3]))
        if name == "ssm":  # (L, B, H, P, N)
            return P(None, batch_ax, ax_t(shape[2]), None, None)
        raise ValueError(name)

    # The sequence dim's divisibility needs a real max_len.
    shapes = cache_shapes(cfg, batch, max(fsdp_size, 8) * 64)
    return {name: ({k: spec_for(k, v) for k, v in shape.items()} if isinstance(shape, dict)
                   else spec_for(name, shape))
            for name, shape in shapes.items()}


class DecodeEngine:
    """Prefill and greedy-decode bodies over a :class:`Model`.  Methods take
    the model where the reference takes its parameter tree."""

    def __init__(self, model: Model):
        self.model = model

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    def init_cache(self, batch: int, max_len: int) -> Cache:
        dev, cdt = self.model.device, dtype_of(self.cfg.dtype)

        def zeros(name, shape):
            return torch.zeros(shape, dtype=torch.int32 if name == "cur" else cdt, device=dev)

        return {name: ({k: zeros(k, v) for k, v in shape.items()} if isinstance(shape, dict)
                       else zeros(name, shape))
                for name, shape in cache_shapes(self.cfg, batch, max_len).items()}

    def cache_specs(self, mesh, batch: int, fsdp: Tuple[str, ...] = ("pod", "data"),
                    tp: str = "model") -> Dict:
        """The cache's specs on ``mesh`` (:func:`cache_specs`)."""
        return cache_specs(self.cfg, mesh, batch, fsdp=fsdp, tp=tp)

    def _qkv(self, h: torch.Tensor, blk: Dict, positions: torch.Tensor):
        """q (B, S, H, hd), k and v (B, S, KV, hd) of normed input ``h``,
        qk-normed and rotated to ``positions``."""
        cfg = self.cfg
        return L.project_qkv(h, blk["attn"], num_heads=cfg.num_heads,
                             num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                             qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
                             rope_theta=cfg.rope_theta, positions=positions)

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

    def _cross_q(self, h: torch.Tensor, cblk: Dict) -> torch.Tensor:
        """A cross layer's q (B, S, H, hd) of normed input ``h``: qk-normed,
        no RoPE."""
        cfg = self.cfg
        b, s = h.shape[:2]
        q = (h @ cblk["attn"]["wq"].to(h.dtype)).reshape(b, s, cfg.num_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = L.rms_norm(q, cblk["attn"]["q_norm"], cfg.norm_eps)
        return q

    def _cross_decode(self, model: Model, x: torch.Tensor, cblk: Dict, ik: torch.Tensor,
                      iv: torch.Tensor) -> torch.Tensor:
        """One token through a vlm cross layer against its cached image K/V
        (B, n_img, KV, hd), all of which it attends to."""
        cfg = self.cfg
        b = x.shape[0]
        q = self._cross_q(L.rms_norm(x, cblk["attn_norm"], cfg.norm_eps), cblk)
        n_img = torch.full((b,), ik.shape[1], dtype=torch.int32, device=x.device)
        out = L.decode_attention(q, ik, iv, n_img).reshape(b, 1, cfg.attn_dim)
        return model.gated(x, cblk, out @ cblk["attn"]["wo"].to(x.dtype))

    def _mlp_or_moe(self, model: Model, x: torch.Tensor, blk: Dict) -> torch.Tensor:
        """The layer's MLP, or the moe family's experts, pre-norm and residual."""
        if "moe" in blk:
            out, _ = model.experts(L.rms_norm(x, blk["mlp_norm"], self.cfg.norm_eps), blk)
            return x + out
        return model.mlp(x, blk)

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
        """batch: tokens (B, 1), or frame_embeds (B, 1, d) for a frame-input
        model.  Returns (logits (B, 1, V), cache), the cache updated in
        place: this token's K/V written at ``cur``, the SSM states advanced,
        and ``cur`` advanced by one."""
        cfg = self.cfg
        cur = cache["cur"]
        x = model.inputs(batch)
        fam = cfg.family
        shared = model.shared_layer() if fam == "hybrid" else None
        cross = model.cross_layers() if fam == "vlm" else []
        for i, blk in enumerate(model.layers()):
            if fam not in ("ssm", "hybrid"):
                x = self._attn_decode(x, blk, cache["k"][i], cache["v"][i], cur)
                x = self._mlp_or_moe(model, x, blk)
                if cross and (i + 1) % cfg.cross_attn_every == 0:
                    g = i // cfg.cross_attn_every
                    x = self._cross_decode(model, x, cross[g], cache["img_k"][g],
                                           cache["img_v"][g])
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
        x = model.inputs(batch)
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
            return x + out.reshape(b, s, cfg.attn_dim) @ blk["attn"]["wo"].to(x.dtype)

        def cross_attention(x, cblk, ik, iv):
            # The image K/V into the cache, then the flash kernel non-causal
            # over all of them.
            kv = model.image_kv(cblk, images)
            ik.copy_(kv[0])
            iv.copy_(kv[1])
            q = self._cross_q(L.rms_norm(x, cblk["attn_norm"], cfg.norm_eps), cblk)
            out = L.flash_attention(q, *kv, causal=False).reshape(b, s, cfg.attn_dim)
            return model.gated(x, cblk, out @ cblk["attn"]["wo"].to(x.dtype))

        fam = cfg.family
        shared = model.shared_layer() if fam == "hybrid" else None
        cross = model.cross_layers() if fam == "vlm" else []
        if cross:
            images = batch["image_embeds"].to(x.dtype)
        for i, blk in enumerate(model.layers()):
            if fam not in ("ssm", "hybrid"):
                x = self._mlp_or_moe(model, attention(x, blk, cache["k"][i], cache["v"][i]), blk)
                if cross and (i + 1) % cfg.cross_attn_every == 0:
                    g = i // cfg.cross_attn_every
                    x = cross_attention(x, cross[g], cache["img_k"][g], cache["img_v"][g])
                continue
            if shared is not None and model.shared_before(i):
                g = i // cfg.attn_every
                x = model.mlp(attention(x, shared, cache["shared"]["k"][g],
                                        cache["shared"]["v"][g]), shared)
            x = self._mamba(x, blk, cache, i, step=False)
        if last_only:
            x = x[:, -1:, :]
        return model.head(x), cache


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------

def _map(fn, shapes: Dict, specs: Dict) -> Dict:
    """``fn(name, shape, spec)`` over the leaves of a (nested) cache tree."""
    return {name: (_map(fn, shape, specs[name]) if isinstance(shape, dict)
                   else fn(name, shape, specs[name]))
            for name, shape in shapes.items()}


def _local_cache(core: _ShardedDecoder, rows: int, max_len: int,
                 total: Optional[int]) -> Tuple[Cache, Dict]:
    """This rank's zeroed cache shard for its ``rows`` rows of a global batch
    of ``total`` (``rows`` times the batch ranks by default), laid out by
    :func:`cache_specs`, and the specs.  A batch that does not divide the
    FSDP axes is held whole by every rank (its sequence fallback: the K/V
    sequence over the non-pod FSDP axes)."""
    from repro_torch.distributed.sharding import axes_size, entry_axes, local_shape

    ctx, cfg = core.ctx, core.cfg
    n_batch = ctx.batch_size
    total = rows * n_batch if total is None else total
    split = bool(ctx.batch_axes) and total % n_batch == 0
    if rows != (total // n_batch if split else total):
        raise ValueError(f"{rows} rows a rank of a batch of {total} over {n_batch} batch "
                         f"ranks: give each rank {total // n_batch if split else total}")
    specs = cache_specs(cfg, ctx.mesh, total, fsdp=ctx.batch_axes, tp=ctx.tp or "model")
    dev = core.params["final_norm"].device

    def zeros(name, shape, spec):
        for d, e in enumerate(tuple(spec)):
            if shape[d] % axes_size(ctx.sizes, entry_axes(e)):
                raise ValueError(f"cache leaf {name} {shape}: dim {d} does not divide over "
                                 f"{entry_axes(e)} (max_len {max_len})")
        return torch.zeros(local_shape(shape, spec, ctx.sizes),
                           dtype=torch.int32 if name == "cur" else core.cdt, device=dev)

    return _map(zeros, cache_shapes(cfg, total, max_len), specs), specs


def _specs_of(core: _ShardedDecoder, cache: Cache) -> Dict:
    """The specs a cache shard was laid out by (its global batch is
    ``cur``'s length)."""
    ctx = core.ctx
    return cache_specs(core.cfg, ctx.mesh, cache["cur"].shape[0], fsdp=ctx.batch_axes,
                       tp=ctx.tp or "model")


def _kv_cache(core: _ShardedDecoder, cache: Cache) -> Cache:
    """The self-attention K/V of the cache: the hybrid's shared block's."""
    return cache["shared"] if core.cfg.family == "hybrid" else cache


def _cache_kind(core: _ShardedDecoder, kc: torch.Tensor) -> str:
    """How a layer's K/V cache shard is laid out over TP: ``"heads"`` (this
    rank's KV heads), ``"head_dim"`` (every KV head, a slice of the head
    dim: the MHA fallback) or ``"whole"``."""
    cfg = core.cfg
    if kc.shape[-2] < cfg.num_kv_heads:
        return "heads"
    if kc.shape[-1] < cfg.head_dim:
        return "head_dim"
    return "whole"


def _seq_axes(core: _ShardedDecoder, specs: Dict) -> Tuple[str, ...]:
    """The axes the self-attention K/V's sequence lies over (the sequence
    fallback's), those of more than one rank; () when it is whole."""
    from repro_torch.distributed.sharding import entry_axes

    kv = _kv_cache(core, specs)
    if "k" not in kv:
        return ()
    axes = entry_axes(tuple(kv["k"])[2])
    return axes if axes and core.lay.size(axes) > 1 else ()


def _rows(core: _ShardedDecoder, rows: int, total: int) -> slice:
    """This rank's rows of the global batch of ``total`` (``cur`` is
    replicated whole); every row where each rank holds them all."""
    start = core.lay.index(core.ctx.batch_axes) * rows if (
        core.ctx.batch_axes and rows < total) else 0
    return slice(start, start + rows)


def _inputs(cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The rows' first-layer input: frame_embeds for a frame-input model,
    else tokens."""
    return batch["frame_embeds"] if cfg.frame_inputs else batch["tokens"]


def _write_kv(core: _ShardedDecoder, kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, first: int = 0) -> None:
    """A prefill's k and v (B, n, KV, hd) into a cache shard whose first
    position is ``first`` (the sequence fallback's slice; 0 otherwise): the
    prompt's positions it holds, this rank's slice of the head dim in the
    MHA fallback."""
    if _cache_kind(core, kc) == "head_dim":
        d = kc.shape[-1]
        k, v = (t.narrow(-1, core.lay.coord[core.tp] * d, d) for t in (k, v))
    n = min(kc.shape[1], k.shape[1] - first)
    if n > 0:
        kc[:, :n] = k[:, first:first + n]
        vc[:, :n] = v[:, first:first + n]


def _ssm_dim(name: str) -> int:
    """The dim of a layer's state leaf that :func:`cache_specs` lays over TP:
    the channels of a conv state (B, K-1, C), the heads of the SSM state
    (B, H, P, N)."""
    return 1 if name == "ssm" else 2


def _ssm_gathers(core: _ShardedDecoder, specs: Dict, name: str) -> bool:
    """Whether the block reads state leaf ``name`` whole while the cache
    holds this rank's TP slice of it: ``conv_b`` and ``conv_c`` whose N
    divides TP (the block needs every N), and ``conv_x`` and ``ssm`` of a
    layer whose heads straddle ranks (it runs whole)."""
    from repro_torch.distributed.sharding import entry_axes

    sliced = core.ctx.tp_size > 1 and core.tp in entry_axes(tuple(specs[name])[1 + _ssm_dim(name)])
    return sliced and not (core.ssm_tp and name in ("conv_x", "ssm"))


def _ssm_read(core: _ShardedDecoder, specs: Dict, cache: Cache, i: int) -> Cache:
    """Layer i's decode state as :meth:`_ShardedDecoder.mamba` reads it, its
    TP slices all-gathered where the block needs them whole."""
    out = {}
    for name in ssm_lib.CACHE_LEAVES:
        t = cache[name][i]
        out[name] = (core.lay.all_gather(t, _ssm_dim(name), core.tp)
                     if _ssm_gathers(core, specs, name) else t)
    return out


def _ssm_write(core: _ShardedDecoder, specs: Dict, cache: Cache, i: int, new: Cache) -> None:
    """The block's new state into layer i's cache shard: this rank's TP
    slice of what it computed whole, right-aligned as the single device
    writes it."""
    for name in ssm_lib.CACHE_LEAVES:
        dst, t = cache[name][i], new[name]
        if _ssm_gathers(core, specs, name):
            dim, n = _ssm_dim(name), dst.shape[_ssm_dim(name)]
            t = t.narrow(dim, core.lay.coord[core.tp] * n, n)
        dst[:, dst.shape[1] - t.shape[1]:].copy_(t)


def sharded_prefill(cfg: ModelConfig, params: Dict, specs: Dict,
                    batch: Dict[str, torch.Tensor], *, max_len: Optional[int] = None,
                    last_only: bool = False,
                    global_batch: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """:meth:`DecodeEngine.prefill` of every family on this rank's shards,
    inside :func:`~repro_torch.distributed.sharding.activation_sharding`
    over a ``DeviceMesh``.

    ``params``: this rank's slices laid out by ``specs`` (``param_specs``);
    ``batch``: this rank's rows (B_local, S) of ``tokens`` (or
    ``frame_embeds``, and the vlm family's ``image_embeds``), the batch over
    the FSDP axes and the same on every TP rank; ``global_batch``: the
    batch's whole size (B_local times the batch ranks by default), and when
    it does not divide the batch ranks every rank holds all of it (the
    cache's sequence fallback).  The layers are the loss's
    (``model._ShardedDecoder.hidden``): attention through the flash kernel
    on this rank's heads or q rows, per ``attn_partition``, each layer's k
    and v (every row's) written into the cache shard (in the sequence
    fallback, the positions of this rank's slice); the moe family routes
    the prompt as the single device does; each vlm cross layer's image k and
    v go into ``img_k`` / ``img_v``; each Mamba2 layer runs this rank's SSD
    heads and writes its conv and SSM states' slices.  Returns ``(logits,
    cache)``: logits (B_local, S or 1, V_local) in the compute type, laid
    out as the reference's dry run lays them out (batch over the FSDP axes,
    the vocabulary over ``"model"`` when it divides); the cache this rank's
    shard under :func:`cache_specs` at the global batch (KV heads over TP,
    or the head dim in the MHA fallback, whose prefill then computes every
    KV head; ``cur`` whole)."""
    b, s = _inputs(cfg, batch).shape[:2]
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({s})")
    core = _ShardedDecoder(cfg, params, specs, "sharded_prefill")
    cache, cspecs = _local_cache(core, b, max_len, global_batch)
    kv = _kv_cache(core, cache)
    seq = _seq_axes(core, cspecs)
    first = core.lay.index(seq) * kv["k"].shape[2] if seq else 0
    images = batch["image_embeds"].to(core.cdt) if cfg.family == "vlm" else None

    def attention(i, h, a, sa):
        kc, vc = kv["k"][i], kv["v"][i]
        out, (k, v) = core.flash_attention(h, core.attn_weights(a, sa),
                                           all_kv=_cache_kind(core, kc) != "heads",
                                           return_kv=True)
        _write_kv(core, kc, vc, k, v, first)
        return out, core.out_layout(s)

    def cross_attention(g, h, a, sa):
        ik, iv = cache["img_k"][g], cache["img_v"][g]
        all_kv = _cache_kind(core, ik) != "heads"
        w = core.attn_weights(a, sa)
        kv = core.image_kv(w, images, all_kv=all_kv)
        _write_kv(core, ik, iv, *kv)
        return core.flash_attention(h, w, all_kv=all_kv, kv=kv), core.out_layout(s)

    def mamba(i, h, m, sm):
        out, layout, new = core.mamba(h, m, sm)
        _ssm_write(core, cspecs, cache, i, new)
        return out, layout

    x = core.hidden(batch, attention, remat=False, cross_attention=cross_attention,
                    mamba=mamba)
    cache["cur"].fill_(s)
    if last_only:
        x = x[:, -1:, :]
    return x @ core.head_weight().to(x.dtype), cache


def _decode_attention(core: _ShardedDecoder, h: torch.Tensor, a: Dict, sa: Dict,
                      kc: torch.Tensor, vc: torch.Tensor, lengths: torch.Tensor,
                      cur: Optional[torch.Tensor] = None, seq: Tuple[str, ...] = ()):
    """One token's attention against a layer's cache shard, by its layout:
    KV heads over TP, this rank's query heads against its KV heads, wo
    row-parallel; the MHA fallback's head-dim slices, every head's scores
    partial over the slice, all-reduced over TP before the softmax, this
    slice of each head's output through wo's matching rows; a cache whole
    on every TP rank, every head.  ``seq``: the axes the cache's sequence
    lies over (the sequence fallback): the rank whose slice holds ``cur``
    writes the new k and v, and each rank's max, sum and output over its
    positions are combined over them.  ``cur`` (a self layer): q and the new
    k, v rotated to it and the k, v written there, the first ``lengths``
    positions attended; without it (a vlm cross layer) q alone, unrotated,
    against the whole image cache.  Returns the output after wo and its
    layout over TP (``"partial"`` or ``"whole"``)."""
    cfg = core.cfg
    b = h.shape[0]
    hd = cfg.head_dim
    kind = _cache_kind(core, kc)
    w = core.attn_weights(a, sa, whole=kind != "heads")
    n_q, n_kv = ((core.part.q_heads[1], core.part.kv_heads[1]) if kind == "heads"
                 else (cfg.num_heads, cfg.num_kv_heads))
    if cur is not None:
        q, k, v = L.project_qkv(h, w, num_heads=n_q, num_kv_heads=n_kv, head_dim=hd,
                                qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
                                rope_theta=cfg.rope_theta, positions=cur[:, None])
    else:
        q = (h @ w["wq"].to(h.dtype)).reshape(b, 1, n_q, hd)
        if cfg.qk_norm:
            q = L.rms_norm(q, w["q_norm"], cfg.norm_eps)
    wo = w["wo"]
    reduce = None
    if kind == "head_dim":
        d = kc.shape[-1]
        d0 = core.lay.coord[core.tp] * d
        q = q.narrow(-1, d0, d)
        if cur is not None:
            k, v = k.narrow(-1, d0, d), v.narrow(-1, d0, d)
        wo = wo.reshape(n_q, hd, -1).narrow(1, d0, d).reshape(n_q * d, -1)
        reduce = functools.partial(core.lay.all_reduce, axes=core.tp)
    first, reduce_seq = 0, None
    if seq:
        n = kc.shape[1]
        first = core.lay.index(seq) * n

        def reduce_seq(t, maximum):
            op = torch.distributed.ReduceOp.MAX if maximum else torch.distributed.ReduceOp.SUM
            return core.lay.all_reduce(t, seq, op=op)
    if cur is not None:
        rows = torch.arange(b, device=h.device)
        at = cur - first
        if seq:   # only the rank whose slice holds cur writes it
            mine = ((at >= 0) & (at < kc.shape[1]))[:, None, None]
            at = at.clamp(0, kc.shape[1] - 1)
            k_new = torch.where(mine, k[:, 0].to(kc.dtype), kc[rows, at])
            v_new = torch.where(mine, v[:, 0].to(vc.dtype), vc[rows, at])
        else:
            k_new, v_new = k[:, 0].to(kc.dtype), v[:, 0].to(vc.dtype)
        kc[rows, at] = k_new
        vc[rows, at] = v_new
    out = L.decode_attention(q, kc, vc, lengths, head_dim=hd, reduce_scores=reduce,
                             first=first, reduce_seq=reduce_seq)
    return out.reshape(b, 1, -1) @ wo.to(h.dtype), core._partial(kind != "whole")


def sharded_decode_step(cfg: ModelConfig, params: Dict, specs: Dict, cache: Cache,
                        batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Cache]:
    """:meth:`DecodeEngine.decode_step` of every family on this rank's
    shards (as :func:`sharded_prefill` takes them) and its cache shard,
    updated in place.  ``batch``: this rank's rows (B_local, 1) of
    ``tokens``, or ``frame_embeds`` (B_local, 1, d); all rows when the
    global batch (``cur``'s length) does not divide the batch ranks.

    Attention is the plain ``layers.decode_attention`` (the reference's
    decode is jnp) on the cache's layout (:func:`_decode_attention`): the
    self layers (the hybrid's shared block) write this token's k and v at
    ``cur``; in the sequence fallback each rank attends to its slice of the
    positions and the flash-style all-reduce pair combines them; the vlm
    cross layers attend to their whole image cache; the moe family routes
    the step's tokens as groups of one, as the single device does; each
    Mamba2 layer runs one step of its SSD heads from its state, ``conv_b``
    and ``conv_c`` all-gathered over TP where the cache holds N slices.
    Returns ``(logits (B_local, 1, V_local), cache)`` with ``cur``
    advanced."""
    b = _inputs(cfg, batch).shape[0]
    cur_all = cache["cur"]
    core = _ShardedDecoder(cfg, params, specs, "sharded_decode_step")
    cur = cur_all[_rows(core, b, cur_all.shape[0])]
    cspecs = _specs_of(core, cache)
    kv = _kv_cache(core, cache)
    seq = _seq_axes(core, cspecs)

    def attention(i, h, a, sa):
        return _decode_attention(core, h, a, sa, kv["k"][i], kv["v"][i], cur + 1, cur, seq)

    def cross_attention(g, h, a, sa):
        ik = cache["img_k"][g]
        n_img = torch.full((b,), ik.shape[1], dtype=torch.int32, device=h.device)
        return _decode_attention(core, h, a, sa, ik, cache["img_v"][g], n_img)

    def mamba(i, h, m, sm):
        out, layout, new = core.mamba(h, m, sm, cache=_ssm_read(core, cspecs, cache, i))
        _ssm_write(core, cspecs, cache, i, new)
        return out, layout

    x = core.hidden(batch, attention, remat=False, cross_attention=cross_attention,
                    mamba=mamba)
    cache["cur"] = cur_all + 1
    return x @ core.head_weight().to(x.dtype), cache
