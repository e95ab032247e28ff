"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

64L d_model=2560 (attn-free) vocab=50280, ssm_state=128, head_dim=64,
expand=2 (d_inner=5120, 80 heads).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    tie_embeddings=True,
).validate()
