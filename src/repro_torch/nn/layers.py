"""Basic layers: RMSNorm and the token embedding with its tied readout.

Every module declares ``inits`` — ``{parameter name: initializer}`` — which
``nn.initializers.init_weights`` draws from one generator.  Weights
keep the reference's (in, out) layout, so a product is ``x @ w`` and the
weights carry across from the JAX package without transposes.
"""
from __future__ import annotations

import torch
from torch import nn

from . import initializers as ini


def param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(
        torch.empty(shape, dtype=dtype, device=device), requires_grad=False
    )


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, eps: float = 1e-6, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.eps = eps
        self.scale = param((d,), dtype, device)
        self.inits = {"scale": ini.ones}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(x.dtype)


class Embedding(nn.Module):
    """Token embedding (vocab, d); also the tied readout."""

    def __init__(self, vocab: int, d_model: int, *, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.table = param((vocab, d_model), dtype, device)
        self.inits = {"table": ini.normal(0.02)}

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens.long()]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied readout: logits = x @ table.T, returned in f32 (computed in
        the weights' dtype with the library's f32 accumulation)."""
        return torch.matmul(x, self.table.t()).float()
