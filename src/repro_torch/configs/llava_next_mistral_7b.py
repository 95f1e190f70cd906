"""llava-next-mistral-7b — VLM backbone (reference
``configs/llava_next_mistral_7b.py``).

Mistral-7B backbone: 32 layers, d_model 4096, 32 heads (GQA kv 8) of 128,
d_ff 14336, vocab 32000, untied head.  The vision frontend is a stub:
precomputed patch embeddings (B, P, d_model) prefix the token sequence, and
the loss runs over the text positions.  7.24 B parameters, 14.48 GB in bf16.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    rope_theta=1000000.0,
    norm="rms",
    mlp="swiglu",
    tie_embeddings=False,
    frontend="patches",
    frontend_fraction=0.125,
)
