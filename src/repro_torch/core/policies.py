"""Repair-value policies: ``(x, mask) -> repaired values``; the caller does
the final ``where``.

Ported: zero, constant and the sign-preserving ``clamp_finite_max``.  The
tile-local ``neighbor_mean`` fill is not ported yet (the serving engine's
fill is zero, and the paged kernels reject it anyway): asking for it raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


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


zero = RepairPolicy("zero", _zero)
clamp_finite_max = RepairPolicy("clamp_finite_max", _clamp_finite_max)


def constant(c: float) -> RepairPolicy:
    return RepairPolicy(f"constant({c})", _constant(c))


_REGISTRY = {"zero": zero, "clamp_finite_max": clamp_finite_max}

NOT_PORTED = {
    "neighbor_mean": "ROADMAP 'Modules still to port': core/policies.py "
    "neighbor_mean (tile-local pairwise f32 fold)",
}


def get(name_or_policy) -> RepairPolicy:
    """Resolve a policy by name (config-friendly) or pass one through."""
    if isinstance(name_or_policy, RepairPolicy):
        return name_or_policy
    if isinstance(name_or_policy, (int, float)) and not isinstance(
        name_or_policy, bool
    ):
        return constant(float(name_or_policy))
    if name_or_policy in NOT_PORTED:
        raise NotImplementedError(
            f"repair policy {name_or_policy!r} is not ported: "
            f"{NOT_PORTED[name_or_policy]}"
        )
    try:
        return _REGISTRY[name_or_policy]
    except KeyError:
        raise KeyError(
            f"unknown repair policy {name_or_policy!r}; "
            f"known: {sorted(_REGISTRY)} or a float constant"
        ) from None
