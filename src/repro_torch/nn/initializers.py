"""Parameter initializers: the reference's scheme (distributions and
scales), drawn from an explicit ``torch.Generator`` — not its bits."""
from __future__ import annotations

import math

import torch
from torch import nn


def normal(stddev: float = 0.02):
    def init(shape, dtype, generator, device):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * stddev).to(dtype)
    return init


def zeros(shape, dtype, generator, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, dtype, generator, device):
    return torch.ones(shape, dtype=dtype, device=device)


def fan_in(scale: float = 1.0):
    """LeCun-style 1/sqrt(fan_in), fan-in = the second-to-last dim of a
    matrix (the reference's (in, out) layout)."""
    def init(shape, dtype, generator, device):
        fi = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale / math.sqrt(max(fi, 1))
        return normal(std)(shape, dtype, generator, device)
    return init


@torch.no_grad()
def init_weights(model: nn.Module, seed: int, device: torch.device) -> None:
    """Draw every module's ``inits`` (``{parameter name: initializer}``) in
    module order from one generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules():
        for name, init in getattr(module, "inits", {}).items():
            p = getattr(module, name)
            p.copy_(init(tuple(p.shape), p.dtype, gen, p.device))
