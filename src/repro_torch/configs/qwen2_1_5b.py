"""qwen2-1.5b — dense GQA LM [arXiv:2407.10671; hf].

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936.
QKV bias, RMSNorm, SwiGLU, tied embeddings, rope theta 1e6.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
    norm="rms",
    mlp="swiglu",
    tie_embeddings=True,
)
