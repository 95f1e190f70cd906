"""In-place scrub: repair every fatal lane of a buffer, or of some of its
pages, and count them.  Kernel: ``csrc/scrub.cu``.

Counts are int32[3] = [nan lanes, inf lanes, tiles with ≥1 fatal lane],
on the reference's logical tile grid (``core.tiling.fit_blocks`` over the
2-D view, leading dims folded into rows).  Both versions write back in
place into the given tensor — the reference returns a new array that XLA
aliases onto its input — and return it.

On the card one call is one launch, which :func:`launch_plan` sizes.  The
kernel streams each page's 16-byte words and sums its counts into a
workspace: an int32 buffer of ``WS_HEADER + 2 * ceil(n_tiles / 32)`` (a
header, the bitmap of logical tiles with a counted fatal lane, and the list
of bitmap words the call set), which its last block reads out into
``counts`` and leaves zeroed.  The wrapper keeps one workspace per (device,
stream), grown and never shrunk.  Calls on one stream run in order, so each
finds it zeroed; a call on another stream gets its own (the one-stream
rule: a workspace is never shared by two streams).  Page ids of up to
``MAX_IDS_BY_VALUE`` pages go into the launch's parameters; more are copied
to the card through a pinned host buffer (one per device and stream) with
an asynchronous copy just before the launch, which first waits for the
previous such copy to have read that buffer.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import detect, tiling
from . import _native, common, tile_fill

_SIGNATURE = [
    _native.P, _native.I, _native.P, _native.I, _native.I, _native.LL,
    _native.LL, _native.LL, _native.LL, _native.LL, _native.HOST_INTS,
    _native.U, _native.P, _native.I, _native.I, _native.I, _native.P,
    _native.LL, _native.P, _native.P,
]

# launch geometry (csrc/scrub.cu: kThreads, kUnroll, kBlocksPerSM, kMaxIds,
# WS_HEADER)
THREADS = 256
MAX_CHUNK_WORDS = THREADS * 4 * 4   # four rounds of kUnroll = 4 loads a thread
BLOCKS_PER_SM = 4                   # all resident at once (launch bounds)
MAX_IDS_BY_VALUE = 512
WS_HEADER = 8
_WHOLE = (ctypes.c_int * 1)(0)      # the whole buffer: one page, id 0


class LaunchPlan(NamedTuple):
    vec_lanes: int          # lanes per 16-byte load
    ids: str                # "value" (launch parameters) or "staged"
    chunk_words: int        # 16-byte words a block takes at a time
    chunks_per_page: int
    grid: int
    n_words: int            # bitmap words: ceil(n_tiles / 32)
    workspace_ints: int     # WS_HEADER + 2 * n_words


def launch_plan(elem_bytes: int, n_pages: int, page_elems: int,
                n_tiles: int, n_sms: int) -> LaunchPlan:
    """The kernel's launch for ``n_pages`` pages of ``page_elems`` lanes of
    ``elem_bytes`` bytes each, counted on ``n_tiles`` logical tiles, on a
    card of ``n_sms`` SMs.  Chunks halve from ``MAX_CHUNK_WORDS`` (down to
    one word a thread) until there are two a SM; the grid takes one block a
    chunk, up to ``BLOCKS_PER_SM`` a SM, and those blocks stride over the
    rest."""
    lanes = 16 // elem_bytes
    words = page_elems // lanes          # the most whole words a page holds
    chunk = MAX_CHUNK_WORDS
    while chunk > THREADS and n_pages * -(-words // chunk) < 2 * n_sms:
        chunk //= 2
    per_page = max(1, -(-words // chunk))
    if n_pages * per_page >= 2 ** 31:
        raise ValueError(f"scrub kernel: {n_pages} pages of {page_elems} lanes")
    n_words = -(-n_tiles // 32)
    return LaunchPlan(
        vec_lanes=lanes,
        ids="value" if n_pages <= MAX_IDS_BY_VALUE else "staged",
        chunk_words=chunk, chunks_per_page=per_page,
        grid=min(n_pages * per_page, BLOCKS_PER_SM * n_sms),
        n_words=n_words, workspace_ints=WS_HEADER + 2 * n_words,
    )


class _Staging(NamedTuple):
    pinned: torch.Tensor    # host int32, page-locked
    ids: torch.Tensor       # device int32
    copied: "torch.cuda.Event"


# per (device index, stream handle)
_WORKSPACES: Dict[Tuple[int, int], torch.Tensor] = {}
_STAGING: Dict[Tuple[int, int], _Staging] = {}


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _workspace(device: torch.device, key, n_ints: int) -> torch.Tensor:
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < n_ints:
        # zeroed here, once; every call leaves it zeroed
        grown = 2 * ws.numel() if ws is not None else 0
        ws = torch.zeros(max(n_ints, grown), dtype=torch.int32, device=device)
        _WORKSPACES[key] = ws
    return ws


def _stage(ids: Sequence[int], device: torch.device, key) -> int:
    """Copy ``ids`` to the card through the pinned buffer of ``key``;
    returns the device address of the copy."""
    n = len(ids)
    st = _STAGING.get(key)
    if st is None or st.ids.numel() < n:
        size = max(n, 2 * st.ids.numel() if st is not None else 0)
        st = _Staging(torch.empty(size, dtype=torch.int32, pin_memory=True),
                      torch.empty(size, dtype=torch.int32, device=device),
                      torch.cuda.Event())
        _STAGING[key] = st
    else:
        st.copied.synchronize()     # the last copy has read the pinned buffer
    st.pinned[:n].numpy()[:] = ids
    st.ids[:n].copy_(st.pinned[:n], non_blocking=True)
    st.copied.record(torch.cuda.current_stream(device))
    return st.ids.data_ptr()


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
    fixed, nan_m, inf_m = common.repair_tile(x2, consts, policy, constant,
                                             block)
    x2.copy_(fixed)
    if count_rows:
        keep = (torch.arange(rows, device=x2.device) < count_rows)[:, None]
        nan_m, inf_m = nan_m & keep, inf_m & keep
    tiles = (nan_m | inf_m).reshape(rows // br, br, cols // bc, bc)
    events = tiles.any(dim=3).any(dim=1).sum()
    return torch.stack([nan_m.sum(), inf_m.sum(), events]).to(torch.int32)


def _kernel(
    x: torch.Tensor, ids: Sequence[int], page_elems: int, cols: int,
    rows_process: int, count_rows: int, block: Tuple[int, int], det,
    policy: str, constant: float, fills: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One launch over ``len(ids)`` pages of ``page_elems`` lanes, page i
    at ``ids[i] * page_elems``; rows of the gathered view at or past
    ``count_rows`` (0: no bound) are repaired but not counted.  ``fills``:
    the ``neighbor_mean`` table of the gathered view's logical tiles."""
    if not x.is_contiguous():
        raise ValueError("scrub kernel needs a contiguous tensor")
    detect.layout_of(x.dtype)          # raises on an unsupported dtype
    if x.element_size() not in (2, 4):
        raise TypeError(f"scrub kernel supports 16/32-bit floats, got {x.dtype}")
    br, bc = block
    dev = x.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    stream = common.raw_stream(dev)
    key = (index, stream)
    plan = launch_plan(x.element_size(), len(ids), page_elems,
                       -(-rows_process // br) * (cols // bc), _n_sms(index))
    ws = _workspace(dev, key, plan.workspace_ints)
    if plan.ids == "staged":
        id_arg = _stage(ids, dev, key)
    elif ids is _WHOLE:
        id_arg = _WHOLE
    else:
        id_arg = (ctypes.c_int * len(ids))(*ids)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    err = _native.function("scrub", "repro_scrub", _SIGNATURE)(
        x.data_ptr(), x.element_size(), id_arg, len(ids),
        int(plan.ids == "staged"), page_elems, cols, count_rows * cols, br, bc,
        common.host_ints(common.cached_operand(det, x.dtype)),
        common.fill_bits(policy, constant, x.dtype), common.table_ptr(fills),
        plan.chunk_words,
        plan.chunks_per_page, plan.grid, ws.data_ptr(), plan.n_words,
        counts.data_ptr(), stream,
    )
    _native.check(err, "scrub")
    common.LAUNCHES["scrub"] += 1
    return counts


def _scrub_args(x, include_inf, block, detector):
    det = common.resolve_detector(detector, include_inf)
    rows, cols = _view2d(x)
    block = block if block is not None else tiling.fit_blocks(rows, cols)
    return det, rows, cols, block


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
    det, rows, cols, block = _scrub_args(x, include_inf, block, detector)
    consts = common.detector_operand(det, x.dtype, n_valid_rows)
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
    det, rows, cols, block = _scrub_args(x, include_inf, block, detector)
    fills = tile_fill.table_or_none(policy, x, rows, cols, block,
                                    common.cached_operand(det, x.dtype))
    counts = _kernel(x, _WHOLE, rows * cols, cols, rows, n_valid_rows, block,
                     det, policy, constant, fills)
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
    return ids, rows_per_page, cols, valid_rows, block, det


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
    ids, rpp, cols, valid_rows, block, det = _pages_args(
        x, page_ids, include_inf, block, detector, n_valid
    )
    if ids.size == 0:
        return x, torch.zeros(3, dtype=torch.int32, device=x.device)
    consts = common.detector_operand(det, x.dtype, valid_rows)
    idx = torch.as_tensor(ids, device=x.device)
    rows = x[idx].reshape(ids.size * rpp, cols)
    counts = _plain(rows, consts, policy, constant, block, valid_rows)
    x[idx] = rows.reshape((ids.size,) + tuple(x.shape[1:]))
    return x, counts


def live_ids(ids: np.ndarray, n_valid: Optional[int]) -> list:
    """The pages the kernel visits: ``ids[:n_valid]`` (all without
    ``n_valid``), which must be unique, with every later id repeating one
    of them, so no two blocks scrub one page."""
    n_live = ids.size if n_valid is None else int(n_valid)
    live = ids[:n_live].tolist()
    seen = set(live)
    if len(seen) != len(live) or not seen.issuperset(ids[n_live:].tolist()):
        raise ValueError(
            "scrub_pages kernel needs unique valid ids and padding that "
            "repeats them"
        )
    return live


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
    the valid ids must be unique, so no two blocks scrub one page.

    ``neighbor_mean`` takes the means of the gathered view's tiles, padding
    rows included.  A padding duplicate can sit in another tile than the
    page it repeats and so have another mean; the kernel repairs the page
    once, with its valid entry's tile, where the reference's scatter of the
    two copies is unordered: parity holds for ids whose duplicates share
    the mean (unique ids without ``n_valid`` always do)."""
    kw = dict(policy=policy, constant=constant, include_inf=include_inf,
              block=block, detector=detector, n_valid=n_valid)
    if common.require_device(x, "scrub_pages") == "cpu":
        return scrub_pages_plain(x, page_ids, **kw)
    ids, rpp, cols, valid_rows, block, det = _pages_args(
        x, page_ids, include_inf, block, detector, n_valid
    )
    if ids.size == 0:
        return x, torch.zeros(3, dtype=torch.int32, device=x.device)
    live = live_ids(ids, n_valid)
    fills = tile_fill.table_or_none(
        policy, x, ids.size * rpp, cols, block,
        common.cached_operand(det, x.dtype), ids=ids.tolist(),
        rows_per_page=rpp, page_stride=rpp * cols)
    counts = _kernel(x, live, rpp * cols, cols, len(live) * rpp, valid_rows,
                     block, det, policy, constant, fills)
    return x, counts
