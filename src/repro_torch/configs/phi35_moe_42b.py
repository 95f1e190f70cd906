"""phi3.5-moe-42b-a6.6b — MoE LM [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L, d_model 4096, 32 heads (GQA kv=8), per-expert d_ff 6400, vocab 32064,
16 experts top-2, LayerNorm, untied embeddings.  Expert weights are the
prime approximate-memory resident (big, cold, read-mostly); the router is
pinned to the exact region (``core.regions``, ``nn/moe.py``).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=6400,
    vocab=32064,
    head_dim=128,
    rope_theta=10000.0,
    norm="ln",
    mlp="swiglu",
    tie_embeddings=False,
    n_experts=16,
    top_k=2,
)
