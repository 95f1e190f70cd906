"""mistral-large-123b — dense GQA LM
[hf:mistralai/Mistral-Large-Instruct-2407].

88L, d_model 12288, 96 heads (GQA kv=8), d_ff 28672, vocab 32768.
RMSNorm, SwiGLU, untied embeddings, rope theta 1e6.  At ~246 GB in bf16
it does not fit one card; its reduced twin runs on the CPU.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv=8,
    d_ff=28672,
    vocab=32768,
    head_dim=128,
    rope_theta=1000000.0,
    norm="rms",
    mlp="swiglu",
    tie_embeddings=False,
)
