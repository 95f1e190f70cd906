"""Repair-value policies: ``(x, mask) -> repaired values``; the caller does
the final ``where``.

Ported: zero, constant, the sign-preserving ``clamp_finite_max``, the
tile-local ``neighbor_mean`` (bit-equal to the reference: the same tile
grid and the same order-fixed pairwise f32 fold) and ``from_reference``
(a checkpointed tensor's values).  The kernels' in-tile
``neighbor_mean`` is a different, kernel-level fill (``kernels.common``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import tiling


@dataclasses.dataclass(frozen=True)
class RepairPolicy:
    """A named repair-value policy."""

    name: str
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    def __call__(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.fn(x, mask)


def _zero(x, mask):
    return torch.zeros_like(x)


def _constant(c):
    def fn(x, mask):
        return torch.full_like(x, c)
    return fn


def _clamp_finite_max(x, mask):
    """Largest finite magnitude of the dtype, keeping the sign bit where it
    survived; NaN lanes (sign undefined) get +max."""
    big = torch.finfo(x.dtype).max
    neg = torch.sign(x) < 0          # False for NaN and for -0.0
    return torch.where(
        neg, torch.full_like(x, -big), torch.full_like(x, big)
    )


def _pairwise_sum(v: torch.Tensor) -> torch.Tensor:
    """Order-fixed pairwise (halving) sum along the last axis, zero-padded
    to a power of two: a fixed tree of elementwise adds, so the result is
    bit-equal to the reference's fold."""
    n = v.shape[-1]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (p - n,))], dim=-1)
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def _neighbor_mean(x, mask):
    """Tile-local mean of the finite lanes on the ``tiling.fit_blocks``
    grid of the trailing-dim-flattened 2-D view, summed in f32 by the
    pairwise fold and cast to ``x``'s dtype."""
    if x.numel() == 0:
        return x
    x2 = x.reshape(1, -1) if x.dim() < 2 else x.reshape(-1, x.shape[-1])
    rows, cols = x2.shape
    br, bc = tiling.fit_blocks(rows, cols)

    def tiles(t):                 # (R, C) -> (R/br, C/bc, br*bc)
        t = t.reshape(rows // br, br, cols // bc, bc).transpose(1, 2)
        return t.reshape(rows // br, cols // bc, br * bc)

    ok = tiles((~mask).reshape(rows, cols))
    vals = torch.where(ok, tiles(x2).float(), 0.0)
    total = _pairwise_sum(vals)
    cnt = _pairwise_sum(ok.float()).clamp_min(1.0)
    mean = (total / cnt).to(x.dtype)
    fill = mean[:, None, :, None].expand(rows // br, br, cols // bc, bc)
    return fill.reshape(x.shape)


zero = RepairPolicy("zero", _zero)
clamp_finite_max = RepairPolicy("clamp_finite_max", _clamp_finite_max)
neighbor_mean = RepairPolicy("neighbor_mean", _neighbor_mean)


def constant(c: float) -> RepairPolicy:
    return RepairPolicy(f"constant({c})", _constant(c))


def from_reference(ref: torch.Tensor) -> RepairPolicy:
    """Repair from a reference tensor of the same shape, the checkpointed
    leaf of the ``last_checkpoint`` policy (``core.checkpoint_repair``):
    the exact pre-flip value up to one checkpoint interval of staleness."""
    def fn(x, mask):
        return ref.to(device=x.device, dtype=x.dtype)
    return RepairPolicy("from_reference", fn)


_REGISTRY = {
    "zero": zero,
    "clamp_finite_max": clamp_finite_max,
    "neighbor_mean": neighbor_mean,
}


def get(name_or_policy) -> RepairPolicy:
    """Resolve a policy by name (config-friendly) or pass one through."""
    if isinstance(name_or_policy, RepairPolicy):
        return name_or_policy
    if isinstance(name_or_policy, (int, float)) and not isinstance(
        name_or_policy, bool
    ):
        return constant(float(name_or_policy))
    try:
        return _REGISTRY[name_or_policy]
    except KeyError:
        raise KeyError(
            f"unknown repair policy {name_or_policy!r}; "
            f"known: {sorted(_REGISTRY)} or a float constant"
        ) from None
