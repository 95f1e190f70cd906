"""SwiGLU feed-forward block (llama/qwen family)."""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from . import initializers as ini
from .layers import UseSites, matmul_f32, param

_WEIGHTS = ("w_gate", "w_up", "w_down")


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype=torch.bfloat16,
                 device=None, rcfg: Any = None, path: str = ""):
        super().__init__()
        self.w_gate = param((d_model, d_ff), dtype, device)
        self.w_up = param((d_model, d_ff), dtype, device)
        self.w_down = param((d_ff, d_model), dtype, device)
        self.inits = {n: ini.fan_in() for n in _WEIGHTS}
        self.reads = UseSites(rcfg, path, _WEIGHTS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        read = self.reads.read
        g = matmul_f32(x, read("w_gate", self.w_gate))
        u = matmul_f32(x, read("w_up", self.w_up))
        h = (torch.nn.functional.silu(g) * u).to(x.dtype)
        return torch.matmul(h, read("w_down", self.w_down)).to(x.dtype)
