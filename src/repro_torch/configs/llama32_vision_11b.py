"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L total = 32 self-attn + 8 gated cross-attn layers (one after every 4 self
layers), d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.  The vision
tower is a stub per the assignment: ``input_specs`` provides precomputed
patch embeddings (1600 tokens, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    cross_attn_every=4,
    num_image_tokens=1600,
    rope_theta=5e5,
).validate()
