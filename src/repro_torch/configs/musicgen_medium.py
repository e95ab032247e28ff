"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

48L d_model=1536 24H (kv=24 => MHA) d_ff=6144 vocab=2048.  The EnCodec
frontend (codebook interleaving / delay pattern) is a stub per the
assignment: ``input_specs`` provides precomputed frame embeddings; logits
target the 2048-entry codec vocabulary.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    d_ff=6144,
    vocab_size=2048,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    frame_inputs=True,
).validate()
