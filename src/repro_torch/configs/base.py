"""Architecture configuration: the fields of the reference's ``ArchConfig``
that the ported families read (the dense, MoE and patch-prefix decoders,
the Zamba hybrid and the xLSTM stack), with its ``reduced()`` test variant
and a map from the dtype name to a torch dtype."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..runtime import ApproxConfig

_DTYPES = {
    "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    norm: str = "rms"
    mlp: str = "swiglu"
    tie_embeddings: bool = True
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    ssm_state: int = 0                  # zamba: Mamba2 state size N
    ssm_head_dim: int = 64              # zamba: Mamba2 head dim P
    mamba_per_attn: int = 2             # zamba: mamba layers per shared-attn
    n_shared_blocks: int = 2            # zamba: alternating shared blocks
    slstm_every: int = 8                # xlstm: every k-th block is sLSTM
    frontend: str = "none"              # none | patches | frames
    frontend_fraction: float = 0.125    # fraction of seq that is frontend tokens

    dtype_name: str = "bfloat16"
    repair: ApproxConfig = ApproxConfig(
        mode="memory", policy="neighbor_mean", max_magnitude=1e3
    )
    ssm_chunk: int = 128                # chunk length of the mLSTM and of Mamba2's SSD
    attn_q_block: int = 512             # chunked attention's tiles
    attn_kv_block: int = 1024
    remat: bool = True                  # training: recompute each block

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype_name]

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Same family at test scale, in f32 (the reference's ``reduced``)."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            dtype_name="float32",
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32,
            mamba_per_attn=2,       # 4 reduced layers: 2 groups, no tail
            slstm_every=4,          # 4 reduced layers: 1 group of 3+1
            ssm_chunk=16,
            attn_q_block=64,
            attn_kv_block=64,
        )
