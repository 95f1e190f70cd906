"""Shared repair logic of the kernels and their plain versions.

Detection inside a kernel is data, not code: the IEEE layout constants and
the detector's enables travel as an int32[8] operand (layout on
``core.rules``), slot 6 carrying the scrub's count-valid row bound.  The
plain versions below decode the same operand with the same bucket rules, so
the CUDA kernels, the plain versions and the reference all agree on which
lanes are fatal and how they are counted.

Kernel fills are zero, constant, ``clamp_finite_max`` (the kernel form:
+max on every repaired lane) and ``neighbor_mean``: the f32 mean of the
non-fatal lanes of the lane's logical tile, rounded to the storage dtype
(reference ``kernels/common.py::repair_value``).  The kernels read that
mean from a per-tile table (``kernels.tile_fill``); the plain versions
form the same table with :func:`tile_means`.
"""
from __future__ import annotations

import collections
import functools
from typing import Optional, Sequence, Tuple

import torch

from ..core import detect, policies as policies_lib, rules as rules_lib
from . import _native

KERNEL_POLICIES = ("zero", "constant", "neighbor_mean", "clamp_finite_max")

# storage dtypes the kernels take, by the code of ``repro::DType``
# (csrc/repair.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# launches per kernel wrapper: bumped only where a CUDA kernel is launched
LAUNCHES: collections.Counter = collections.Counter()
# the same per (wrapper, route) of the wrappers with routes, e.g.
# ("repair_matmul", "f32")
ROUTE_LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
    ROUTE_LAUNCHES.clear()


def kernel_fill(fill) -> Optional[Tuple[str, float]]:
    """Map a ``RepairRule`` fill onto a kernel (policy, constant) pair that
    is bit-identical to the tensor-level repair — value-independent fills
    only; anything else returns ``None``."""
    if isinstance(fill, (int, float)) and not isinstance(fill, bool):
        return ("constant", float(fill))
    if fill == "zero":
        return ("zero", 0.0)
    if isinstance(fill, policies_lib.RepairPolicy) and fill.name == "zero":
        return ("zero", 0.0)
    return None


def resolve_detector(
    detector: Optional[rules_lib.Detector], include_inf: bool
) -> rules_lib.Detector:
    """An explicit detector wins; otherwise the legacy ``include_inf`` knob
    lifts into the equivalent detector."""
    if detector is not None:
        return detector
    return rules_lib.Detector(nan=True, inf=include_inf)


def detector_operand(
    detector: Optional[rules_lib.Detector], dtype: torch.dtype,
    n_valid_rows: int = 0,
) -> Tuple[int, ...]:
    """The int32[8] detector-constants operand as Python ints, folded into
    int32 range by two's complement (masks are bit patterns); ``None``
    gives the all-off row.  The kernels take it by value."""
    if detector is None:
        return (0,) * 8
    consts = list(detector.constants(dtype))
    consts[6] = int(n_valid_rows)
    return tuple(detect.signed(int(c), 32) for c in consts)


def masks_from_consts(
    bits: torch.Tensor, consts: Sequence[int], width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nan_mask, inf_mask) of a bit view under the constants operand.
    Compares as uint32 the way the reference does: a 16-bit view widens by
    zero extension, and the operand's slots are read back as unsigned.
    Custom bit patterns land in the NaN bucket; the range guard owns the
    non-NaN bucket when enabled."""
    u = [int(c) & 0xFFFFFFFF for c in consts]
    b = bits.to(torch.int64) & ((1 << width) - 1)
    exp_mask, man_mask, flags = u[0], u[1], u[2]
    exp_all = (b & exp_mask) == exp_mask
    man_nz = (b & man_mask) != 0
    false = torch.zeros_like(exp_all)
    nan_m = exp_all & man_nz if flags & rules_lib.FLAG_NAN else false
    if flags & rules_lib.FLAG_BITPATTERN:
        nan_m = nan_m | ((b & u[4]) == u[5])
    inf_m = exp_all & ~man_nz if flags & rules_lib.FLAG_INF else false
    if flags & rules_lib.FLAG_RANGE:
        inf_m = inf_m | (((b & exp_mask) >= u[3]) & ~nan_m)
    return nan_m, inf_m


def fatal_masks(
    x: torch.Tensor, consts: Sequence[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``masks_from_consts`` on a float tensor."""
    return masks_from_consts(
        detect.bits_of(x), consts, detect.layout_of(x.dtype).width
    )


def fill_value(policy: str, constant: float, dtype: torch.dtype) -> float:
    """The repaired value of a kernel fill, already rounded to ``dtype``
    (so the f32 value handed to a kernel converts to ``dtype`` exactly).
    ``neighbor_mean`` has no single value: its lanes read a per-tile table,
    and the scalar handed beside it is 0 and unused."""
    if policy in ("zero", "neighbor_mean"):
        v = 0.0
    elif policy == "constant":
        v = constant
    elif policy == "clamp_finite_max":
        v = torch.finfo(dtype).max
    else:
        raise ValueError(
            f"kernel policy must be one of {KERNEL_POLICIES}, got {policy!r}"
        )
    return float(torch.tensor(v, dtype=dtype).to(torch.float32))


@functools.lru_cache(maxsize=None)
def fill_bits(policy: str, constant: float, dtype: torch.dtype) -> int:
    """Bit pattern of the repaired lane in ``dtype`` (unsigned)."""
    v = torch.tensor(fill_value(policy, constant, dtype), dtype=dtype)
    lay = detect.layout_of(dtype)
    return int(detect.bits_of(v.reshape(1))[0]) & ((1 << lay.width) - 1)


# the wgmma routes' host path: detector operands and their ctypes int32[8]
# by value (their detectors must be hashable)
cached_operand = functools.lru_cache(maxsize=None)(detector_operand)
host_ints = functools.lru_cache(maxsize=None)(_native.int8_array)


def tile_means(
    x2: torch.Tensor, fatal: torch.Tensor, block: Tuple[int, int]
) -> torch.Tensor:
    """The ``neighbor_mean`` fill of every (br, bc) tile of the 2-D ``x2``
    (rows/br, cols/bc), in its dtype: the f32 sum of the tile's non-fatal
    lanes over their count (at least 1), rounded to the dtype, as the
    reference's ``repair_value`` forms it."""
    rows, cols = x2.shape
    br, bc = block
    if rows % br or cols % bc:
        raise ValueError(f"block {block} must divide {tuple(x2.shape)}")
    ok = ~fatal.reshape(rows // br, br, cols // bc, bc)
    vals = torch.where(ok, x2.float().reshape(ok.shape), 0.0)
    total = vals.sum(dim=(1, 3))
    n = ok.sum(dim=(1, 3)).float().clamp_min(1.0)
    return (total / n).to(x2.dtype)


def _view2d(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]) if x.dim() >= 2 else x.reshape(1, -1)


def repair_tile(
    x: torch.Tensor, consts: Sequence[int], policy: str, constant: float,
    block: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(repaired, nan_mask, inf_mask): every fatal lane of ``x`` takes the
    kernel fill.  Masks, not counts: callers count per tile visit.
    ``neighbor_mean`` takes the mean of the lane's ``block`` tile of the
    trailing-dim 2-D view (the calling kernel's logical tile)."""
    nan_m, inf_m = fatal_masks(x, consts)
    fatal = nan_m | inf_m
    if policy == "neighbor_mean":
        x2 = _view2d(x)
        br, bc = block
        means = tile_means(x2, _view2d(fatal), (br, bc))
        fill = means.repeat_interleave(br, dim=0).repeat_interleave(bc, dim=1)
        fill = fill.reshape(x.shape)
    else:
        fill = torch.full_like(x, fill_value(policy, constant, x.dtype))
    return torch.where(fatal, fill, x), nan_m, inf_m


def table_ptr(table: Optional[torch.Tensor]):
    """The device address of a fill table for a launch, or None (NULL): the
    kernel then writes the scalar fill."""
    return None if table is None else table.data_ptr()


def raw_stream(device: torch.device) -> int:
    """The handle of the current CUDA stream on ``device``, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it but without
    building a ``Stream`` object (which switches the current device twice:
    ~9 µs of a wrapper's host path on the H100's host)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def require_device(x: torch.Tensor, what: str, *inputs: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a wrapper's dispatch; anything else raises.  On
    'cuda' the kernel route refuses autograd inputs (``refuse_autograd``
    over ``x`` and ``inputs``); the plain versions are autograd's own."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.device.type == "cuda":
        refuse_autograd(what, x, *inputs)
    return x.device.type


def refuse_autograd(what: str, *inputs: Optional[torch.Tensor]) -> None:
    """Raise where grad mode is on and a float input requires grad: the
    kernels read and write raw device memory and have no backward, so
    their result would be silently cut off from the graph."""
    if not torch.is_grad_enabled():
        return
    for t in inputs:
        if t is not None and t.is_floating_point() and t.requires_grad:
            raise RuntimeError(
                f"{what}: the CUDA kernel has no backward, and an input "
                "requires grad; call it under torch.no_grad() or on detached "
                "tensors"
            )
