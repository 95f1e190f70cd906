"""Flash attention (online softmax) with the K/V tiles repaired on load:
the serving-path form of fused reactive repair.  Kernel:
``csrc/flash_attention.cu``.

Layout (the reference's): q (B, H, S, D), k/v (B, Kh, T, D), query head
``h`` reads KV head ``h // (H / Kh)``; out (B, H, S, D) in q's dtype.
Causal masking is aligned top-left, as the reference *kernel* has it:
query position ``s`` sees key positions ``t <= s`` (for S < T the keys
past S - 1 are never seen).  The reference's oracle aligns bottom-right
instead; the port follows the kernel.

Counts (int32[8], the reference's AT layout) are defined on the logical
``blocks = (bq, bk)`` grid of the reference call: the K/V tile
(b, kh, kj) is visited ``G · L(kj)`` times, G = H / Kh and
L(kj) = #{qi : kj·bk <= qi·bq + bq - 1} when causal (S / bq otherwise), so

  nan_k … ev_v   that weight times the tile's lanes, or its 0/1 fatal flag
  ev_total       that weight times (K tile fatal or V tile fatal)

and tiles that are never live count 0.  ``neighbor_mean`` fills a fatal
K/V lane with the mean of its logical (bk, D) tile of the (B*Kh*T, D)
view, from a table per operand that ``kernels.tile_fill`` writes first.

Routes on the card (:func:`route`, a pure function of the operands'
dtypes, shapes and data pointers, decided before any launch):

  ``"wgmma"``  q, k and v all bf16 or all f16, contiguous, head dim 64 or
               128, non-empty, each data pointer 16-byte aligned, fewer
               than 2³¹ lanes in q and in k (the kernels' int offsets).  A
               scan kernel reads K and V once, counts every fatal lane of
               the logical live prefix and flags the main kernel's
               ``WGMMA_TILE`` K/V tiles that hold one, over every row the
               main kernel loads; the main kernel (TMA ring, ``wgmma`` on
               the tensor cores, online softmax in registers) repairs only
               the flagged tiles, in shared memory.  It rounds the softmax
               weights to the operand dtype before the value product.
  ``"ffma"``   everything else: f32 (exact f32, never TF32), unaligned or
               empty operands.  Each tile is repaired as it is loaded and
               multiplied on the FP32 pipe, the weights kept in f32.

A failure on either route raises; neither falls back to the other.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Optional, Tuple

import torch

from ..core import tiling
from . import _native, common, tile_fill

NEG_INF = -1e30

# counts layout (int32[8])
NAN_K, INF_K, EV_K, NAN_V, INF_V, EV_V, EV_TOTAL = range(7)

KERNEL_HEAD_DIMS = (64, 128)

# (BQ, BKV) of the wgmma route's main kernel (csrc/flash_attention.cu,
# namespace fw): q tiles of BQ rows, K/V tiles of BKV rows, which the scan
# flags
WGMMA_TILE = (128, 128)
_WGMMA_DTYPES = (torch.bfloat16, torch.float16)
_WGMMA_MAX_LANES = 1 << 31     # csrc: repro_flash_attention_wgmma


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"wgmma"`` or ``"ffma"``: which CUDA kernels take the call (the
    rule in the module docstring)."""
    ops = (q, k, v)
    if (q.dtype == k.dtype == v.dtype and q.dtype in _WGMMA_DTYPES
            and q.dim() == 4 and q.shape[-1] in KERNEL_HEAD_DIMS
            and all(0 < t.numel() < _WGMMA_MAX_LANES for t in ops)
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ops)):
        return "wgmma"
    return "ffma"


def _default_blocks(S: int, T: int) -> Tuple[int, int]:
    """The reference's default logical blocks."""
    return tiling.fit(S, 512), tiling.fit(T, 512)


def _spec(q, k, v, include_inf, blocks, detector):
    """The logical blocks and the K and V detector operands of a call,
    after checking the shapes (cached by value: the wrapper's host path)."""
    return _shape_spec(q.shape, k.shape, v.shape, k.dtype, v.dtype, include_inf,
                       None if blocks is None else tuple(blocks), detector)


@functools.lru_cache(maxsize=256)
def _shape_spec(q_shape, k_shape, v_shape, k_dtype, v_dtype, include_inf,
                blocks, detector):
    if len(q_shape) != 4 or len(k_shape) != 4 or k_shape != v_shape:
        raise ValueError("flash_attention needs q (B, H, S, D) and k, v "
                         "(B, Kh, T, D) of one shape")
    B, H, S, D = q_shape
    Bk, Kh, T, Dk = k_shape
    if Bk != B or Dk != D or H % Kh:
        raise ValueError(f"flash_attention: q {tuple(q_shape)} does not fit "
                         f"k/v {tuple(k_shape)}")
    return _blocks_and_consts(S, T, k_dtype, v_dtype, include_inf, blocks,
                              detector)


def _blocks_and_consts(S, T, k_dtype, v_dtype, include_inf, blocks, detector):
    """The logical blocks and the K and V detector operands."""
    bq, bk = blocks if blocks is not None else _default_blocks(S, T)
    if S % bq or T % bk:
        raise ValueError(f"blocks {(bq, bk)} must divide (S, T) = {(S, T)}")
    det = common.resolve_detector(detector, include_inf)
    return ((bq, bk), common.cached_operand(det, k_dtype),
            common.cached_operand(det, v_dtype))


def _live_visits(S: int, T: int, bq: int, bk: int, causal: bool) -> torch.Tensor:
    """L(kj): how many logical q tiles visit K/V tile kj (int64, (T/bk,))."""
    kj = torch.arange(T // bk)
    if not causal:
        return torch.full_like(kj, S // bq)
    q_last = torch.arange(S // bq) * bq + bq - 1
    return (kj[None, :] * bk <= q_last[:, None]).sum(dim=0)


def _at_counts(tiles: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The int32[8] counts from per-logical-tile lane counts ``tiles``
    (..., nk, 4) = [NaN K, Inf K, NaN V, Inf V] and visit weights (nk,)."""
    t = tiles.to(torch.int64)
    w = weights.to(torch.int64).to(t.device)
    fk = (t[..., 0] + t[..., 1]) > 0
    fv = (t[..., 2] + t[..., 3]) > 0
    zero = t.new_zeros(())
    return torch.stack([
        (w * t[..., 0]).sum(), (w * t[..., 1]).sum(), (w * fk).sum(),
        (w * t[..., 2]).sum(), (w * t[..., 3]).sum(), (w * fv).sum(),
        (w * (fk | fv)).sum(), zero,
    ]).to(torch.int32)


def _scan_rows(S: int, T: int, bk: int, causal: bool) -> Tuple[int, int]:
    """(rows counted, rows read) per (b, kh) by the wgmma route's scan: the
    logical live prefix, and beyond it every row that some ``WGMMA_TILE``
    q tile of the main kernel loads (csrc: live_tiles, scan_rows)."""
    nk = T // bk
    live = (min(nk, -(-S // bk)) if causal else nk) * bk
    tq = WGMMA_TILE[0]
    loaded = min(T, -(-S // tq) * tq) if causal else T
    return live, max(live, loaded)


def scan_plain(
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    S: int,
    causal: bool = True,
    include_inf: bool = True,
    blocks: Optional[Tuple[int, int]] = None,
    detector=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the wgmma route's scan kernel for k, v
    (B, Kh, T, D) and S query rows: ``(tiles, flags)``, int32.  ``tiles``
    (B, Kh, T/bk, 4) are the [NaN K, Inf K, NaN V, Inf V] lanes of each
    logical tile of the live prefix (0 past it), the input of the closed
    forms; ``flags`` (B, Kh, ceil(T/BKV), 2) mark the [K, V] tiles of
    ``WGMMA_TILE`` rows that hold a fatal lane in a row the scan reads."""
    B, Kh, T, D = k.shape
    (_, bk), consts_k, consts_v = _blocks_and_consts(
        S, T, k.dtype, v.dtype, include_inf, blocks, detector)
    live, rows = _scan_rows(S, T, bk, causal)
    nan_k, inf_k = common.fatal_masks(k, consts_k)
    nan_v, inf_v = common.fatal_masks(v, consts_v)
    pos = torch.arange(T, device=k.device)[:, None]
    lanes = torch.stack([nan_k, inf_k, nan_v, inf_v], dim=-1) & (pos < live)[..., None]
    tiles = lanes.reshape(B, Kh, T // bk, bk * D, 4).sum(dim=3)
    fatal = torch.stack([(nan_k | inf_k).any(-1), (nan_v | inf_v).any(-1)], dim=-1)
    tk = WGMMA_TILE[1]
    fatal = torch.nn.functional.pad((fatal & (pos < rows)).to(torch.int32),
                                    (0, 0, 0, -T % tk))
    return tiles.to(torch.int32), fatal.reshape(B, Kh, -1, tk, 2).amax(dim=3)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
    blocks: Optional[Tuple[int, int]] = None,
    detector=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`flash_attention_raw` (any
    device): repair K/V, full softmax in f32 with the top-left causal mask,
    counts by the closed forms."""
    (bq, bk), consts_k, consts_v = _spec(q, k, v, include_inf, blocks, detector)
    B, H, S, D = q.shape
    Kh, T = k.shape[1], k.shape[2]
    G = H // Kh
    fk, nan_k, inf_k = common.repair_tile(k, consts_k, policy, constant, (bk, D))
    fv, nan_v, inf_v = common.repair_tile(v, consts_v, policy, constant, (bk, D))
    lanes = torch.stack([nan_k, inf_k, nan_v, inf_v], dim=-1)
    tiles = lanes.reshape(B, Kh, T // bk, bk * D, 4).sum(dim=3)
    counts = _at_counts(tiles, G * _live_visits(S, T, bq, bk, causal))
    kx = fk.float().repeat_interleave(G, dim=1)
    vx = fv.float().repeat_interleave(G, dim=1)
    s = torch.matmul(q.float(), kx.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    if causal:
        pos_q = torch.arange(S, device=q.device)[:, None]
        pos_k = torch.arange(T, device=q.device)[None, :]
        s = torch.where(pos_q >= pos_k, s, NEG_INF)
    out = torch.matmul(torch.softmax(s, dim=-1), vx)
    return out.to(q.dtype), counts


_SIGNATURE = [
    _native.P, _native.P, _native.P, _native.P, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.F, _native.HOST_INTS, _native.HOST_INTS,
    _native.U, _native.U, _native.P, _native.P, _native.P, _native.P,
    _native.P,
]
_WGMMA_SIGNATURE = _SIGNATURE[:-3] + [_native.P] * 4
_SCAN_SIGNATURE = [
    _native.P, _native.P, _native.I, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.HOST_INTS,
    _native.HOST_INTS, _native.P, _native.P, _native.P,
]


def _scratch_sizes(B: int, Kh: int, T: int, bk: int):
    """int32 lengths of (counts, tiles, flags)."""
    return [8, 4 * B * Kh * (T // bk), 2 * B * Kh * -(-T // WGMMA_TILE[1])]


def _scratch(B, Kh, T, bk, dev):
    """One int32 buffer and the data pointers of its parts (counts, tiles,
    flags), which the native calls zero or write in full on the stream; the
    flags are tiny and there on either route."""
    sizes = _scratch_sizes(B, Kh, T, bk)
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    return buf, [base + 4 * o for o in itertools.accumulate([0] + sizes[:-1])]


def _scan_kernel(k, v, S, causal, blocks, consts_k, consts_v, ptrs):
    """The wgmma route's scan alone, into the parts at ``ptrs`` (from
    :func:`_scratch`): the kernel twin of :func:`scan_plain`, which the
    wgmma route's entry point launches itself."""
    B, Kh, T, D = k.shape
    err = _native.function("flash_attention", "repro_flash_scan",
                           _SCAN_SIGNATURE)(
        k.data_ptr(), v.data_ptr(), common.DTYPE_CODES[k.dtype], B, Kh, S, T,
        D, blocks[1], int(causal), common.host_ints(consts_k),
        common.host_ints(consts_v),
        *ptrs[1:], common.raw_stream(k.device),
    )
    _native.check(err, "flash_attention scan")


def _kernel(q, k, v, causal, blocks, consts_k, consts_v, policy, constant):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on "
                             f"{q.device}")
    B, H, S, D = q.shape
    Kh, T = k.shape[1], k.shape[2]
    path = route(q, k, v)
    if path == "ffma":           # what the wgmma route's rule already holds
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"flash_attention kernel: {name} must be "
                                 f"contiguous")
        if not (q.dtype == k.dtype == v.dtype) or q.dtype not in common.DTYPE_CODES:
            raise TypeError("flash_attention kernel: q, k and v must share an "
                            "f32/bf16/f16 dtype")
        if D not in KERNEL_HEAD_DIMS:
            raise ValueError(f"flash_attention kernel supports head dims "
                             f"{KERNEL_HEAD_DIMS}, got {D}")
    buf, (counts, tiles, flags) = _scratch(B, Kh, T, blocks[1], q.device)
    out = torch.empty_like(q)
    kv_rows, kv_block = B * Kh * T, (blocks[1], D)
    fills_k = tile_fill.table_or_none(policy, k, kv_rows, D, kv_block, consts_k)
    fills_v = tile_fill.table_or_none(policy, v, kv_rows, D, kv_block, consts_v)
    head = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        common.DTYPE_CODES[q.dtype], B, H, Kh, S, T, D, *blocks, int(causal),
        1.0 / math.sqrt(D), common.host_ints(consts_k), common.host_ints(consts_v),
        common.fill_bits(policy, constant, k.dtype),
        common.fill_bits(policy, constant, v.dtype),
        common.table_ptr(fills_k), common.table_ptr(fills_v),
    )
    stream = common.raw_stream(q.device)
    if path == "wgmma":          # scan, main kernel and counts
        err = _native.function("flash_attention", "repro_flash_attention_wgmma",
                               _WGMMA_SIGNATURE)(*head, tiles, flags, counts, stream)
    else:
        err = _native.function("flash_attention", "repro_flash_attention",
                               _SIGNATURE)(*head, tiles, counts, stream)
    _native.check(err, f"flash_attention ({path})")
    common.LAUNCHES["flash_attention"] += 1
    return out, buf[:8]


def flash_attention_raw(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
    blocks: Optional[Tuple[int, int]] = None,
    detector=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (B, H, S, D), counts int32[8])``: online-softmax attention
    over the repaired K/V tiles.  K and V are not modified (register-mode
    core; ``ops.flash_attention`` adds the memory-mode origin scrub)."""
    kw = dict(causal=causal, policy=policy, constant=constant,
              include_inf=include_inf, blocks=blocks, detector=detector)
    if common.require_device(q, "flash_attention") == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    blocks, consts_k, consts_v = _spec(q, k, v, include_inf, blocks, detector)
    return _kernel(q, k, v, causal, blocks, consts_k, consts_v, policy,
                   constant)
