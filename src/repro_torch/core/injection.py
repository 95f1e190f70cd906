"""Approximate-memory simulation: bit-flip injection with a refresh→BER model.

The only place errors are created.  ``flip_bits`` draws on an explicit
``torch.Generator``; its stream differs from the reference's ``jax.random``
stream, so parity with the reference is statistical (the flip count is
Poisson(n_bits · ber)), while the XOR fold of given positions is exact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from . import detect

# (refresh_interval_seconds, log10_ber, memory_energy_saving_fraction)
_ANCHORS = (
    (0.064, -17.0, 0.00),
    (0.256, -9.0, 0.161),   # RAIDR
    (1.0, -6.0, 0.225),     # Flikker (midpoint of 20-25 %)
    (4.0, -4.0, 0.30),
)


@dataclasses.dataclass(frozen=True)
class ApproxMemoryModel:
    """A point in the refresh/BER/energy trade-off space."""

    refresh_interval_s: float
    ber: float
    energy_saving: float

    @staticmethod
    def from_refresh(refresh_interval_s: float) -> "ApproxMemoryModel":
        t = float(refresh_interval_s)
        xs = [a[0] for a in _ANCHORS]
        if t <= xs[0]:
            _, lb, es = _ANCHORS[0]
            return ApproxMemoryModel(t, 10.0 ** lb, es)
        if t >= xs[-1]:
            _, lb, es = _ANCHORS[-1]
            return ApproxMemoryModel(t, 10.0 ** lb, es)
        for (t0, lb0, e0), (t1, lb1, e1) in zip(_ANCHORS, _ANCHORS[1:]):
            if t0 <= t <= t1:
                w = (math.log(t) - math.log(t0)) / (math.log(t1) - math.log(t0))
                return ApproxMemoryModel(
                    t, 10.0 ** (lb0 + w * (lb1 - lb0)), e0 + w * (e1 - e0)
                )
        raise AssertionError("unreachable")


def _flip_budget(numel: int, width: int, ber: float) -> int:
    """Cap on flips per call: λ + 6σ (the reference's static budget)."""
    lam = numel * width * ber
    return max(8, int(math.ceil(lam + 6.0 * math.sqrt(lam) + 1)))


def xor_fold(
    x: torch.Tensor, positions: torch.Tensor, bit_idx: torch.Tensor
) -> Tuple[torch.Tensor, int]:
    """Flip bit ``bit_idx[i]`` of element ``positions[i]`` of ``x`` (flat
    indexing) for every i, duplicates folding by XOR exactly as two physical
    flips on one bit restore it.  Returns ``(flipped copy, bits changed)``."""
    lay = detect.layout_of(x.dtype)
    bits = detect.bits_of(x.reshape(-1)).clone()
    key = positions.to(torch.int64) * lay.width + bit_idx.to(torch.int64)
    uniq, counts = torch.unique(key, return_counts=True)
    odd = uniq[counts % 2 == 1]                 # (position, bit) pairs that flip
    if odd.numel():
        pos = torch.div(odd, lay.width, rounding_mode="floor")
        one = torch.ones_like(odd)
        masks = torch.bitwise_left_shift(one, odd % lay.width)
        upos, inv = torch.unique(pos, return_inverse=True)
        # distinct bits of one position: their sum is their OR
        word = torch.zeros_like(upos).index_add_(0, inv, masks)
        word = word.to(lay.int_dtype)           # wraps into two's complement
        bits[upos] = bits[upos] ^ word
    return detect.from_bits(bits, x.dtype).reshape(x.shape), int(odd.numel())


def flip_bits_counted(
    x: torch.Tensor, ber: float, generator: torch.Generator
) -> Tuple[torch.Tensor, int]:
    """Flip each bit of ``x`` independently with probability ``ber``: draw
    k ~ Poisson(n_bits · ber) (capped at the static budget), place k uniform
    flips.  Returns ``(flipped copy, bits that changed)``."""
    if not x.is_floating_point():
        raise TypeError("flip_bits expects a floating-point tensor")
    lay = detect.layout_of(x.dtype)
    numel = x.numel()
    budget = _flip_budget(numel, lay.width, ber)
    dev = x.device
    lam = torch.tensor([numel * lay.width * ber], dtype=torch.float32, device=dev)
    k = int(min(torch.poisson(lam, generator=generator).item(), budget))
    positions = torch.randint(0, numel, (k,), generator=generator, device=dev)
    bit_idx = torch.randint(0, lay.width, (k,), generator=generator, device=dev)
    return xor_fold(x, positions, bit_idx)


def flip_bits(
    x: torch.Tensor, ber: float, generator: torch.Generator
) -> torch.Tensor:
    """``flip_bits_counted`` without the count."""
    return flip_bits_counted(x, ber, generator)[0]


def inject_nan(
    x: torch.Tensor, n: int = 1, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Force exactly ``n`` distinct-position NaNs into a copy of ``x`` with
    the reference's tag pattern (exponent all ones + a fixed mantissa)."""
    lay = detect.layout_of(x.dtype)
    bits = detect.bits_of(x.reshape(-1)).clone()
    perm = torch.randperm(bits.numel(), generator=generator, device=x.device)
    tag = detect.signed(lay.exp_mask | (lay.man_mask & 0x4241424142414241), lay.width)
    bits[perm[:n]] = tag
    return detect.from_bits(bits, x.dtype).reshape(x.shape)


def expected_nan_fraction(dtype: torch.dtype, ber: float) -> float:
    """The reference's analytic estimate of P[a value becomes NaN/Inf after
    one window]: ``ber`` times the fraction of typical small-weight
    exponents one flip away from all ones, ≈ ``exp_bits · 2^-(exp_bits-1)``.
    For test assertions only."""
    lay = detect.layout_of(dtype)
    return ber * lay.exp_bits * (2.0 ** -(lay.exp_bits - 1))
