"""Model configuration dataclass: the port's copy of ``repro.models.config``.

One frozen config fully determines parameter shapes and the block schedule.
The dataclass, its derived properties, ``validate()`` and ``reduced()`` are
copied as they are, so a config compares field by field with the
reference's.  Families:

* ``dense``  — pre-norm decoder (GQA + SwiGLU), optional qk-norm.
* ``moe``    — dense attention + top-k routed experts (optional dense
  residual; ``repro_torch.models.moe``).
* ``ssm``    — Mamba2 / SSD blocks alone (``repro_torch.models.ssm``).
* ``hybrid`` — Mamba2 blocks with one weight-shared attention + MLP block
  applied every ``attn_every`` layers (Zamba2).
* ``vlm``    — dense decoder with a gated cross-attention layer over
  precomputed image-patch embeddings after every ``cross_attn_every``
  self-attention layers.
* ``audio``  — dense decoder over precomputed frame embeddings; logits over
  the codec vocab.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0                # 0 => attention-free
    num_kv_heads: int = 0
    head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False      # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (Zamba2) ---
    attn_every: int = 0               # apply the shared attn block every k layers

    # --- VLM ---
    cross_attn_every: int = 0         # insert a cross-attn layer after every k
    num_image_tokens: int = 0
    # --- audio ---
    frame_inputs: bool = False        # inputs are precomputed frame embeddings

    # --- misc ---
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"           # compute dtype
    param_dtype: str = "float32"
    remat: bool = True                # activation checkpointing per layer

    # ---- derived ----
    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0 or self.family == "hybrid"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM/hybrid only)."""
        return self.family in ("ssm", "hybrid")

    def validate(self) -> "ModelConfig":
        if self.family in ("dense", "moe", "vlm", "audio"):
            assert self.num_heads > 0 and self.head_dim > 0
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, "GQA group size"
        if self.family == "moe":
            assert self.num_experts > 0 and self.experts_per_token > 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.ssm_inner % self.ssm_head_dim == 0
        if self.family == "hybrid":
            assert self.attn_every > 0 and self.num_heads > 0
        if self.family == "vlm":
            assert self.cross_attn_every > 0 and self.num_image_tokens > 0
        return self


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    if cfg.family == "vlm":
        # self-layer count must equal n_cross * cross_attn_every
        n_layers = 2 * (min(cfg.cross_attn_every, 2) + 1)
    elif cfg.family == "hybrid":
        # exercise both the grouped scan and the tail layers
        n_layers = 2 * min(cfg.attn_every, 2) + 1
    else:
        n_layers = min(cfg.num_layers, 2)
    base = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        num_layers=n_layers,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        dense_residual=cfg.dense_residual,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        attn_every=min(cfg.attn_every, 2),
        cross_attn_every=min(cfg.cross_attn_every, 2),
        num_image_tokens=16 if cfg.num_image_tokens else 0,
        frame_inputs=cfg.frame_inputs,
        qk_norm=cfg.qk_norm,
        tie_embeddings=cfg.tie_embeddings,
        remat=False,
        # CPU smoke settings: f32 compute keeps decode/forward parity tight;
        # a large capacity factor disables MoE token dropping so the routed
        # path is sequence-split invariant (capacity depends on group size).
        dtype="float32",
        capacity_factor=8.0,
    )
    base.update(overrides)
    return ModelConfig(**base).validate()
