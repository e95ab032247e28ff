"""zamba2-7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; unverified].

81L d_model=3584 32H (GQA kv=32 => MHA in the shared block) d_ff=14336
vocab=32000, ssm_state=64. The single weight-shared attention+MLP block is
applied every ``attn_every``=6 Mamba2 layers (13 applications + 3 tail
Mamba layers).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    tie_embeddings=True,
).validate()
