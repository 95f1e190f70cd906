"""stablelm-1.6b — dense MHA LM [hf:stabilityai/stablelm-2-1_6b].

24L, d_model 2048, 32 heads (kv=32, full MHA), d_ff 5632, vocab 100352.
LayerNorm, partial rotary (25 % of the head dim), SwiGLU, untied
embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=5632,
    vocab=100352,
    head_dim=64,
    rope_theta=10000.0,
    rotary_pct=0.25,
    norm="ln",
    mlp="swiglu",
    tie_embeddings=False,
)
