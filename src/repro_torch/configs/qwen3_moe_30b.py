"""qwen3-moe-30b-a3b — fine-grained MoE LM [hf:Qwen/Qwen3-30B-A3B; hf].

48L, d_model 2048, 32 heads (GQA kv=4), per-expert d_ff 768, vocab 151936,
128 experts top-8, untied embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    d_ff=768,
    vocab=151936,
    head_dim=128,
    rope_theta=1000000.0,
    norm="rms",
    mlp="swiglu",
    tie_embeddings=False,
    n_experts=128,
    top_k=8,
)
