"""SwiGLU feed-forward block (llama/qwen family)."""
from __future__ import annotations

import torch
from torch import nn

from . import initializers as ini
from .layers import param


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.w_gate = param((d_model, d_ff), dtype, device)
        self.w_up = param((d_model, d_ff), dtype, device)
        self.w_down = param((d_ff, d_model), dtype, device)
        self.inits = {n: ini.fan_in() for n in ("w_gate", "w_up", "w_down")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = torch.matmul(x, self.w_gate).float()
        u = torch.matmul(x, self.w_up).float()
        h = (torch.nn.functional.silu(g) * u).to(x.dtype)
        return torch.matmul(h, self.w_down).to(x.dtype)
