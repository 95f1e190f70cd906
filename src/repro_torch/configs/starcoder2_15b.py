"""starcoder2-15b — dense GQA code LM [arXiv:2402.19173; hf].

40L, d_model 6144, 48 heads (GQA kv=4), d_ff 24576, vocab 49152.
RoPE (theta 1e5), LayerNorm, GeLU MLP with biases, QKV bias, untied
embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=4,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    qkv_bias=True,
    rope_theta=100000.0,
    norm="ln",
    mlp="gelu",
    tie_embeddings=False,
)
