"""In-place scrub: repair every fatal lane of a buffer, or of some of its
pages, and count them.  Kernel: ``csrc/scrub.cu``.

Counts are int32[3] = [nan lanes, inf lanes, tiles with ≥1 fatal lane],
on the reference's logical tile grid (``core.tiling.fit_blocks`` over the
2-D view, leading dims folded into rows).  Both versions write back in
place into the given tensor — the reference returns a new array that XLA
aliases onto its input — and return it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import detect, tiling
from . import _native, common

_SIGNATURE = [
    _native.P, _native.I, _native.P, _native.LL, _native.LL, _native.LL,
    _native.LL, _native.LL, _native.LL, _native.LL, _native.HOST_INTS,
    _native.U, _native.P, _native.P, _native.P,
]


def _view2d(x: torch.Tensor) -> Tuple[int, int]:
    if x.dim() == 0:
        return 1, 1
    if x.dim() == 1:
        return 1, x.shape[0]
    return x.numel() // x.shape[-1], x.shape[-1]


def _plain(
    x2: torch.Tensor, consts, policy: str, constant: float,
    block: Tuple[int, int], count_rows: int,
) -> torch.Tensor:
    """Repair the 2-D view ``x2`` in place; returns the counts."""
    rows, cols = x2.shape
    br, bc = block
    fixed, nan_m, inf_m = common.repair_tile(x2, consts, policy, constant)
    x2.copy_(fixed)
    if count_rows:
        keep = (torch.arange(rows, device=x2.device) < count_rows)[:, None]
        nan_m, inf_m = nan_m & keep, inf_m & keep
    tiles = (nan_m | inf_m).reshape(rows // br, br, cols // bc, bc)
    events = tiles.any(dim=3).any(dim=1).sum()
    return torch.stack([nan_m.sum(), inf_m.sum(), events]).to(torch.int32)


def _kernel(
    x: torch.Tensor, ids: Optional[torch.Tensor], rows_per_page: int,
    page_stride: int, cols: int, rows_process: int, count_rows: int,
    block: Tuple[int, int], consts, policy: str, constant: float,
) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("scrub kernel needs a contiguous tensor")
    detect.layout_of(x.dtype)          # raises on an unsupported dtype
    if x.element_size() not in (2, 4):
        raise TypeError(f"scrub kernel supports 16/32-bit floats, got {x.dtype}")
    br, bc = block
    n_tiles = -(-rows_process // br) * (cols // bc)
    tile_counts = torch.zeros(max(2 * n_tiles, 2), dtype=torch.int32, device=x.device)
    counts = torch.empty(3, dtype=torch.int32, device=x.device)
    err = _native.function("scrub", "repro_scrub", _SIGNATURE)(
        x.data_ptr(), x.element_size(),
        ids.data_ptr() if ids is not None else None,
        rows_per_page, page_stride, cols, rows_process, count_rows, br, bc,
        _native.int8_array(consts), common.fill_bits(policy, constant, x.dtype),
        tile_counts.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _native.check(err, "scrub")
    common.LAUNCHES["scrub"] += 1
    return counts


def _scrub_args(x, include_inf, block, detector, n_valid_rows):
    det = common.resolve_detector(detector, include_inf)
    consts = common.detector_operand(det, x.dtype, n_valid_rows)
    rows, cols = _view2d(x)
    block = block if block is not None else tiling.fit_blocks(rows, cols)
    return consts, rows, cols, block


def scrub_plain(
    x: torch.Tensor,
    *,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
    block: Optional[Tuple[int, int]] = None,
    detector=None,
    n_valid_rows: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`scrub` (any device)."""
    consts, rows, cols, block = _scrub_args(
        x, include_inf, block, detector, n_valid_rows
    )
    return x, _plain(x.view(rows, cols), consts, policy, constant, block,
                     n_valid_rows)


def scrub(
    x: torch.Tensor,
    *,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
    block: Optional[Tuple[int, int]] = None,
    detector=None,
    n_valid_rows: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repair all fatal lanes of ``x`` in place.  Returns ``(x, counts)``.

    ``detector`` picks the fatal patterns (default: NaN, plus ±Inf with
    ``include_inf``).  ``n_valid_rows`` > 0 bounds the COUNTS to the first
    that many folded rows; every row is still repaired."""
    if common.require_device(x, "scrub") == "cpu":
        return scrub_plain(
            x, policy=policy, constant=constant, include_inf=include_inf,
            block=block, detector=detector, n_valid_rows=n_valid_rows,
        )
    consts, rows, cols, block = _scrub_args(
        x, include_inf, block, detector, n_valid_rows
    )
    counts = _kernel(x, None, rows, 0, cols, rows, n_valid_rows, block,
                     consts, policy, constant)
    return x, counts


def _pages_args(x, page_ids, include_inf, block, detector, n_valid):
    ids = np.asarray(page_ids, dtype=np.int64).reshape(-1)
    if x.dim() < 2:
        raise ValueError("scrub_pages needs a page axis plus at least one more")
    if ids.size and (ids.min() < 0 or ids.max() >= x.shape[0]):
        raise IndexError(f"page id out of range for {x.shape[0]} pages")
    det = common.resolve_detector(detector, include_inf)
    rows_per_page = x[0].numel() // x.shape[-1]
    cols = x.shape[-1]
    n_rows = ids.size * rows_per_page
    valid_rows = 0 if n_valid is None else int(n_valid) * rows_per_page
    block = block if block is not None else tiling.fit_blocks(n_rows, cols)
    consts = common.detector_operand(det, x.dtype, valid_rows)
    return ids, rows_per_page, cols, valid_rows, block, consts


def scrub_pages_plain(
    x: torch.Tensor,
    page_ids: Sequence[int],
    *,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
    block: Optional[Tuple[int, int]] = None,
    detector=None,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`scrub_pages` (any device): the
    reference's gather → repair → scatter."""
    ids, rpp, cols, valid_rows, block, consts = _pages_args(
        x, page_ids, include_inf, block, detector, n_valid
    )
    if ids.size == 0:
        return x, torch.zeros(3, dtype=torch.int32, device=x.device)
    idx = torch.as_tensor(ids, device=x.device)
    rows = x[idx].reshape(ids.size * rpp, cols)
    counts = _plain(rows, consts, policy, constant, block, valid_rows)
    x[idx] = rows.reshape((ids.size,) + tuple(x.shape[1:]))
    return x, counts


def scrub_pages(
    x: torch.Tensor,
    page_ids: Sequence[int],
    *,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
    block: Optional[Tuple[int, int]] = None,
    detector=None,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repair rows ``page_ids`` of ``x``'s leading (page) axis in place.
    Returns ``(x, counts)`` with the counts of the reference's gathered
    view: entries ``page_ids[n_valid:]`` are padding duplicates, repaired
    but not counted.  ``page_ids`` is a host sequence (the plan builds it on
    the host); on the card every padding entry must repeat a valid id and
    the valid ids must be unique, so no two blocks scrub one page."""
    kw = dict(policy=policy, constant=constant, include_inf=include_inf,
              block=block, detector=detector, n_valid=n_valid)
    if common.require_device(x, "scrub_pages") == "cpu":
        return scrub_pages_plain(x, page_ids, **kw)
    ids, rpp, cols, valid_rows, block, consts = _pages_args(
        x, page_ids, include_inf, block, detector, n_valid
    )
    if ids.size == 0:
        return x, torch.zeros(3, dtype=torch.int32, device=x.device)
    n_live = ids.size if n_valid is None else int(n_valid)
    live = ids[:n_live]
    if np.unique(live).size != live.size or not np.isin(ids[n_live:], live).all():
        raise ValueError(
            "scrub_pages kernel needs unique valid ids and padding that "
            "repeats them"
        )
    dev_ids = torch.as_tensor(live.astype(np.int32), device=x.device)
    counts = _kernel(
        x, dev_ids, rpp, rpp * cols, cols, n_live * rpp, valid_rows, block,
        consts, policy, constant,
    )
    return x, counts
