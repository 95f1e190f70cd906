"""The ``neighbor_mean`` fill table: one entry per logical tile of a 2-D
view, the f32 mean of the tile's non-fatal lanes rounded to the storage
dtype, as a bit pattern (int32, 16-bit patterns zero-extended).  Kernel:
``csrc/tile_fill.cu``.

Every kernel of the port that repairs with ``neighbor_mean`` launches this
first, on the same stream, once per operand, and reads the entry of a
fatal lane's tile.  The view is ``rows`` x ``cols`` lanes of a contiguous
tensor, row r at element ``offset + r * row_stride``; with ``ids``, row r
at ``ids[r // rows_per_page] * page_stride + (r % rows_per_page) *
row_stride`` (``scrub_pages``' gathered view).  The logical tiles of each
kernel:

  scrub            (br, bc) of the trailing-dim 2-D view (the gathered
                   view of the listed pages for ``scrub_pages``)
  repair_matmul    A (bm, bk), B (bk, bn)
  flash_attention  K and V as (B*Kh*T, D), tiles (bk, D)
  paged pools      one row per page of the layer, pg*Kh*Dh wide, tiles of
                   one row: the table is indexed by page id
  mlstm_chunk      q, k, v as (B*H*nc*Q, P), tiles (Q, P)
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..core import detect
from . import _native, common

_SIGNATURE = [
    _native.P, _native.I, _native.LL, _native.LL, _native.LL, _native.LL,
    _native.LL, _native.P, _native.LL, _native.LL, _native.HOST_INTS,
    _native.P, _native.P,
]


def _view(x: torch.Tensor, rows: int, cols: int, *,
          row_stride: Optional[int] = None, offset: int = 0,
          ids: Optional[Sequence[int]] = None, rows_per_page: int = 1,
          page_stride: int = 0) -> torch.Tensor:
    """The (rows, cols) view as a tensor (a gathered copy with ``ids``):
    what the plain table reads."""
    if not x.is_contiguous():
        raise ValueError("tile_fill needs a contiguous tensor")
    row_stride = cols if row_stride is None else row_stride
    r = torch.arange(rows, device=x.device)
    if ids is None:
        base = offset + r * row_stride
    else:
        pid = torch.as_tensor(list(ids), dtype=torch.int64, device=x.device)
        base = (offset + pid[r // rows_per_page] * page_stride
                + (r % rows_per_page) * row_stride)
    return x.reshape(-1)[base[:, None] + torch.arange(cols, device=x.device)]


def tile_fill_plain(x: torch.Tensor, rows: int, cols: int,
                    block: Tuple[int, int], consts: Sequence[int],
                    **where) -> torch.Tensor:
    """The plain version of :func:`tile_fill` (any device)."""
    x2 = _view(x, rows, cols, **where)
    nan_m, inf_m = common.fatal_masks(x2, consts)
    means = common.tile_means(x2, nan_m | inf_m, block).reshape(-1)
    width = detect.layout_of(x.dtype).width
    bits = detect.bits_of(means).to(torch.int64) & ((1 << width) - 1)
    return bits.to(torch.int32)


def tile_fill(x: torch.Tensor, rows: int, cols: int, block: Tuple[int, int],
              consts: Sequence[int], *, row_stride: Optional[int] = None,
              offset: int = 0, ids: Optional[Sequence[int]] = None,
              rows_per_page: int = 1, page_stride: int = 0) -> torch.Tensor:
    """int32[(rows / br) * (cols / bc)]: the fill's bit pattern of every
    logical tile of the view, row-major over the tile grid.  ``consts`` is
    the detector operand of ``x``'s dtype.  On the card one launch of
    ``tile_fill`` on the current stream; on the CPU the plain version."""
    where = dict(row_stride=row_stride, offset=offset, ids=ids,
                 rows_per_page=rows_per_page, page_stride=page_stride)
    if common.require_device(x, "tile_fill") == "cpu":
        return tile_fill_plain(x, rows, cols, block, consts, **where)
    if not x.is_contiguous():
        raise ValueError("tile_fill kernel needs a contiguous tensor")
    if x.dtype not in common.DTYPE_CODES:
        raise TypeError(f"tile_fill kernel supports f32/bf16/f16, got {x.dtype}")
    br, bc = block
    if rows % br or cols % bc:
        raise ValueError(f"block {block} must divide ({rows}, {cols})")
    fills = torch.empty((rows // br) * (cols // bc), dtype=torch.int32,
                        device=x.device)
    ids_dev = None
    if ids is not None:
        ids_dev = torch.as_tensor(list(ids), dtype=torch.int32).to(x.device)
    err = _native.function("tile_fill", "repro_tile_fill", _SIGNATURE)(
        x.data_ptr() + offset * x.element_size(), common.DTYPE_CODES[x.dtype],
        rows, cols, cols if row_stride is None else row_stride, br, bc,
        common.table_ptr(ids_dev), rows_per_page, page_stride,
        common.host_ints(tuple(consts)), fills.data_ptr(),
        common.raw_stream(x.device),
    )
    _native.check(err, "tile_fill")
    common.LAUNCHES["tile_fill"] += 1
    return fills


def table_or_none(policy: str, x: torch.Tensor, rows: int, cols: int,
                  block: Tuple[int, int], consts: Sequence[int],
                  **where) -> Optional[torch.Tensor]:
    """The fill table of one operand when its policy is ``neighbor_mean``
    and its detector repairs anything; None otherwise (the kernel writes
    its scalar fill, and its launches are as before)."""
    if policy != "neighbor_mean" or not consts[2]:
        return None
    return tile_fill(x, rows, cols, block, consts, **where)


def values(table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A table's entries as values of ``dtype`` (f32 tensor)."""
    lay = detect.layout_of(dtype)
    bits = table.to(torch.int64) & ((1 << lay.width) - 1)
    signed = torch.where(bits >= (1 << (lay.width - 1)), bits - (1 << lay.width), bits)
    return signed.to(lay.int_dtype).view(dtype).float()
