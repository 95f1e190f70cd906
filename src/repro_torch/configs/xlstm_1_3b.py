"""xlstm-1.3b — sLSTM + mLSTM stack [arXiv:2405.04517; unverified].

48 blocks, d_model 2048, 4 heads, vocab 50304, d_ff=0 (blocks carry their
own projections).  Every 8th block is sLSTM (sequential scalar memory), the
rest mLSTM (chunked-parallel matrix memory).  The reference's numbers
(``src/repro/configs/xlstm_1_3b.py``); its dense 4096² q/k/v projections
give 3.47 B parameters, not the published model's 1.3 B (whose q/k/v
projections are block-diagonal).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    norm="rms",
    tie_embeddings=True,
    slstm_every=8,
)
