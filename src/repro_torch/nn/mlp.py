"""Feed-forward blocks: SwiGLU (llama/qwen family) and the GeLU MLP with
biases (gpt family)."""
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


class GeluMLP(nn.Module):
    """The reference's GeLU MLP with biases: ``h = x @ w_up + b_up`` in f32,
    GeLU in its tanh form (``jax.nn.gelu``'s default), rounded once; ``y =
    h @ w_down + b_down`` in f32, rounded once."""

    def __init__(self, d_model: int, d_ff: int, *, dtype=torch.bfloat16,
                 device=None, rcfg: Any = None, path: str = ""):
        super().__init__()
        self.w_up = param((d_model, d_ff), dtype, device)
        self.b_up = param((d_ff,), dtype, device)
        self.w_down = param((d_ff, d_model), dtype, device)
        self.b_down = param((d_model,), dtype, device)
        self.inits = {"w_up": ini.fan_in(), "b_up": ini.zeros,
                      "w_down": ini.fan_in(), "b_down": ini.zeros}
        self.reads = UseSites(rcfg, path, ("w_up", "b_up", "w_down", "b_down"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        read = self.reads.read
        h = matmul_f32(x, read("w_up", self.w_up)) + read("b_up", self.b_up).float()
        h = torch.nn.functional.gelu(h, approximate="tanh").to(x.dtype)
        y = matmul_f32(h, read("w_down", self.w_down)) + read("b_down", self.b_down).float()
        return y.to(x.dtype)
