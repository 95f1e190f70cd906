"""zamba2-7b — hybrid Mamba2 + shared attention (reference
``configs/zamba2_7b.py``).

81 Mamba2 layers, d_model 3584, ssm_state 64, head dim 64; a shared
transformer block (on concat(h, emb) = 7168 wide, 32 heads of 224, d_ff
14336) after every 6 Mamba layers, alternating between 2 parameter sets,
each use with its own down-projection: 13 groups and a tail of 3 layers.
vocab 32000, tied.  7.79 B parameters, 15.59 GB in bf16.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv=32,
    d_ff=14336,
    vocab=32000,
    rope_theta=10000.0,
    norm="rms",
    mlp="swiglu",
    tie_embeddings=True,
    ssm_state=64,
    ssm_head_dim=64,
    mamba_per_attn=6,
    n_shared_blocks=2,
)
