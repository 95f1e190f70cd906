"""Rotary position embeddings (RoPE), with partial-rotary support."""
from __future__ import annotations

import torch


def _angles(positions: torch.Tensor, rot_dim: int, theta: float) -> torch.Tensor:
    """(..., rot_dim/2) angle table for integer positions (f32)."""
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=positions.device) / rot_dim
    inv_freq = 1.0 / (theta ** exponent)
    return positions.float()[..., None] * inv_freq


def apply_rope(
    x: torch.Tensor,            # (..., seq, heads, head_dim)
    positions: torch.Tensor,    # (..., seq)
    *,
    theta: float = 10000.0,
    rotary_pct: float = 1.0,
) -> torch.Tensor:
    head_dim = x.shape[-1]
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    if rot_dim == 0:
        return x
    ang = _angles(positions, rot_dim, theta)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., : rot_dim // 2], xr[..., rot_dim // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    if rot_dim == head_dim:
        return out
    return torch.cat([out, x[..., rot_dim:]], dim=-1)
