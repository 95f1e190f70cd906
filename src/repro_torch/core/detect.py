"""NaN/Inf detection via explicit bit patterns.

A NaN is the stored pattern "exponent all ones, mantissa non-zero"; an
all-ones exponent with a zero mantissa is ±Inf (paper §2.2).  Detection
classifies the stored bits, never ``torch.isnan``, so it distinguishes NaN
from Inf and matches what the CUDA kernels compute on integer views.

Bit views are the same-width *signed* integer dtypes (``torch.int16`` /
``int32`` / ``int64``): every mask below is sign-free or is compared after
masking, so the signed view gives the same answers as an unsigned one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FloatLayout:
    """Bit layout of an IEEE-754 binary float format."""

    width: int             # total bits
    exp_bits: int          # exponent field width
    man_bits: int          # mantissa (fraction) field width
    int_dtype: torch.dtype  # same-width signed integer dtype for views

    @property
    def exp_mask(self) -> int:
        return ((1 << self.exp_bits) - 1) << self.man_bits

    @property
    def man_mask(self) -> int:
        return (1 << self.man_bits) - 1

    @property
    def sign_mask(self) -> int:
        return 1 << (self.width - 1)

    @property
    def abs_mask(self) -> int:
        return self.sign_mask - 1  # everything but the sign bit


_LAYOUTS = {
    torch.float64: FloatLayout(64, 11, 52, torch.int64),
    torch.float32: FloatLayout(32, 8, 23, torch.int32),
    torch.bfloat16: FloatLayout(16, 8, 7, torch.int16),
    torch.float16: FloatLayout(16, 5, 10, torch.int16),
}


def layout_of(dtype: torch.dtype) -> FloatLayout:
    """The IEEE layout of a floating dtype (TypeError if unsupported)."""
    if dtype not in _LAYOUTS:
        raise TypeError(f"no IEEE layout registered for dtype {dtype}")
    return _LAYOUTS[dtype]


def supported_dtypes():
    return tuple(_LAYOUTS.keys())


def signed(value: int, width: int) -> int:
    """``value`` (an unsigned bit pattern) as a ``width``-bit two's
    complement integer — how a pattern with the top bit set fits a signed
    view."""
    value &= (1 << width) - 1
    return value - (1 << width) if value >> (width - 1) else value


def bits_of(x: torch.Tensor) -> torch.Tensor:
    """Same-width signed-integer view of a float tensor."""
    return x.view(layout_of(x.dtype).int_dtype)


def from_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`bits_of`."""
    return bits.view(dtype)


def is_nan_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NaN mask from a bit view: exp all-ones AND mantissa != 0."""
    lay = layout_of(dtype)
    exp_all_ones = (bits & lay.exp_mask) == lay.exp_mask
    return exp_all_ones & ((bits & lay.man_mask) != 0)


def is_inf_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """±Inf mask from a bit view: exp all-ones AND mantissa == 0."""
    lay = layout_of(dtype)
    exp_all_ones = (bits & lay.exp_mask) == lay.exp_mask
    return exp_all_ones & ((bits & lay.man_mask) == 0)


def nan_mask(x: torch.Tensor) -> torch.Tensor:
    return is_nan_bits(bits_of(x), x.dtype)


def inf_mask(x: torch.Tensor) -> torch.Tensor:
    return is_inf_bits(bits_of(x), x.dtype)


_NP_FLOAT = {
    torch.float64: (np.float64, np.uint64),
    torch.float32: (np.float32, np.uint32),
    torch.float16: (np.float16, np.uint16),
}


def exp_field_of(value: float, dtype: torch.dtype) -> int:
    """Exponent-field value of |value| in ``dtype``'s layout.  bf16 takes
    the top half of the f32 pattern (truncation, as the reference does)."""
    lay = layout_of(dtype)
    if dtype == torch.bfloat16:
        bits = int(np.float32(abs(value)).view(np.uint32)) >> 16
    else:
        f, u = _NP_FLOAT[dtype]
        bits = int(np.abs(np.array(value, f)).view(u))
    return (bits & lay.exp_mask) >> lay.man_bits


def is_extreme_bits(
    bits: torch.Tensor, dtype: torch.dtype, threshold: float
) -> torch.Tensor:
    """Lanes with |x| ≥ threshold (±Inf and NaN included) via one compare
    on the exponent field — the beyond-paper range guard."""
    lay = layout_of(dtype)
    field = exp_field_of(threshold, dtype)
    return (bits & lay.exp_mask) >= (field << lay.man_bits)


def extreme_mask(x: torch.Tensor, threshold: float) -> torch.Tensor:
    return is_extreme_bits(bits_of(x), x.dtype, threshold)


def nonfinite_mask(x: torch.Tensor, *, include_inf: bool = True) -> torch.Tensor:
    """Lanes the legacy detector considers fatal: NaN, optionally ±Inf."""
    bits = bits_of(x)
    m = is_nan_bits(bits, x.dtype)
    if include_inf:
        m = m | is_inf_bits(bits, x.dtype)
    return m


def count_nonfinite(x: torch.Tensor, *, include_inf: bool = True) -> torch.Tensor:
    """Total number of fatal lanes (an int32 scalar tensor)."""
    return nonfinite_mask(x, include_inf=include_inf).sum(dtype=torch.int32)
