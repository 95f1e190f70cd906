"""``C = repair(A) @ repair(B)`` with f32 accumulation and event counters:
the paper's register-repairing mechanism fused into the operand load
(Fig. 1 / Table 3).  Kernels: ``csrc/repair_matmul.cu``.

Counts (int32[8], the reference's MM layout) are defined on the logical
``blocks = (bm, bn, bk)`` grid of the reference call, whatever tile the
CUDA kernel runs on.  With ``ni = M/bm``, ``nj = N/bn``, ``nk = K/bk``, an
A tile is visited ``nj`` times and a B tile ``ni`` times, so

  nan_a, inf_a   nj · (NaN / Inf lanes of A)
  ev_a           nj · (A tiles with a fatal lane)
  nan_b … ev_b   the same for B with ni
  ev_total       Σ_k (FA_k·nj + FB_k·ni − FA_k·FB_k): the (i, j, k) visits
                 where either operand's tile had a fatal lane, FA_k / FB_k
                 the fatal A tiles of column k / B tiles of row k

The operands may differ in dtype (f32, bf16, f16); each is classified
with its own detector row.  Fills are the kernel subset (zero, constant,
``neighbor_mean``, ``clamp_finite_max``); ``neighbor_mean`` takes the mean
of the lane's logical tile, A (bm, bk) and B (bk, bn), from a table that
``kernels.tile_fill`` writes per operand before the product.

Routes on the card (:func:`route`, a pure function of the operands'
dtypes, shapes and data pointers, decided before any launch):

  ``"wgmma"``  A and B both bf16 or both f16; M, N, K > 0;
               K % 8 == 0 and N % 8 == 0 (TMA's 16-byte row strides); both
               data pointers 16-byte aligned; fewer than 2³⁵ lanes in A
               and B together (the scan's 32-bit vector index).  A scan
               kernel reads each operand once, counts every fatal lane and
               flags the main kernel's ``WGMMA_TILE`` operand tiles that
               hold one; the main kernel (persistent, TMA ring, ``wgmma``
               on the tensor cores) repairs only the flagged tiles, in
               shared memory.
  ``"ffma"``   every other product: any f32 operand (exact f32, never
               TF32), mixed dtypes, unaligned shapes or views.  Each tile
               is repaired as it is loaded and multiplied on the FP32 pipe.

A failure on either route raises; neither falls back to the other.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch

from ..core import tiling
from . import _native, common, tile_fill

# counts layout (int32[8])
NAN_A, INF_A, EV_A, NAN_B, INF_B, EV_B, EV_TOTAL = range(7)

# (BM, BN, BK) of the wgmma route's main kernel (csrc/repair_matmul.cu,
# namespace wg): the scan flags A tiles of BM x BK and B tiles of BK x BN
WGMMA_TILE = (128, 256, 64)
_WGMMA_DTYPES = (torch.bfloat16, torch.float16)
_WGMMA_MAX_LANES = 8 * ((1 << 32) - 4096)     # csrc: wgmma_shape_ok


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """``"wgmma"`` or ``"ffma"``: which CUDA kernels take ``a @ b`` (the
    rule in the module docstring)."""
    (M, K), N = a.shape, b.shape[1]
    if (a.dtype == b.dtype and a.dtype in _WGMMA_DTYPES
            and M > 0 and N > 0 and K > 0 and K % 8 == 0 and N % 8 == 0
            and M * K + K * N < _WGMMA_MAX_LANES
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0):
        return "wgmma"
    return "ffma"


def _flag_shapes(M: int, N: int, K: int):
    """Shapes of the wgmma route's A and B tile flags."""
    tm, tn, tk = WGMMA_TILE
    return (-(-M // tm), -(-K // tk)), (-(-K // tk), -(-N // tn))


def _default_blocks(M: int, N: int, K: int) -> Tuple[int, int, int]:
    """The reference's default logical blocks."""
    return tiling.fit(M, 256), tiling.fit(N, 256), tiling.fit(K, 512)


def _spec(a, b, include_inf, blocks, out_dtype, detector):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"repair_matmul needs (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    bm, bn, bk = blocks if blocks is not None else _default_blocks(M, N, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"blocks {(bm, bn, bk)} must divide (M, N, K) = "
                         f"{(M, N, K)}")
    det = common.resolve_detector(detector, include_inf)
    consts_a = common.cached_operand(det, a.dtype)
    consts_b = common.cached_operand(det, b.dtype)
    return (bm, bn, bk), consts_a, consts_b, out_dtype or a.dtype


def _mm_counts(tile_a: torch.Tensor, tile_b: torch.Tensor) -> torch.Tensor:
    """The int32[8] counts from per-logical-tile lane counts: ``tile_a``
    (ni, nk, 2) and ``tile_b`` (nk, nj, 2), last axis [NaN, Inf]."""
    ni, nj = tile_a.shape[0], tile_b.shape[1]
    tile_a, tile_b = tile_a.to(torch.int64), tile_b.to(torch.int64)
    fa = (tile_a.sum(-1) > 0).to(torch.int64)            # (ni, nk)
    fb = (tile_b.sum(-1) > 0).to(torch.int64)            # (nk, nj)
    fa_k, fb_k = fa.sum(0), fb.sum(1)                     # (nk,)
    zero = tile_a.new_zeros(())
    return torch.stack([
        nj * tile_a[..., 0].sum(), nj * tile_a[..., 1].sum(), nj * fa.sum(),
        ni * tile_b[..., 0].sum(), ni * tile_b[..., 1].sum(), ni * fb.sum(),
        (fa_k * nj + fb_k * ni - fa_k * fb_k).sum(), zero,
    ]).to(torch.int32)


def _tile_sums(nan_m, inf_m, br, bc):
    """(R/br, C/bc, 2) NaN and Inf lanes per logical tile."""
    R, C = nan_m.shape

    def per_tile(m):
        return m.reshape(R // br, br, C // bc, bc).sum(dim=(1, 3))

    return torch.stack([per_tile(nan_m), per_tile(inf_m)], dim=-1)


def _tile_flags(fatal: torch.Tensor, tr: int, tc: int) -> torch.Tensor:
    """int32 (ceil(R/tr), ceil(C/tc)): 1 where the tile holds a fatal lane."""
    R, C = fatal.shape
    f = torch.nn.functional.pad(fatal.to(torch.int32), (0, -C % tc, 0, -R % tr))
    return f.reshape(f.shape[0] // tr, tr, f.shape[1] // tc, tc).amax(dim=(1, 3))


def scan_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    include_inf: bool = True,
    blocks: Optional[Tuple[int, int, int]] = None,
    detector=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the wgmma route's scan kernel: ``(tiles_a,
    tiles_b, flags_a, flags_b)``, int32.  ``tiles_a`` (ni, nk, 2) and
    ``tiles_b`` (nk, nj, 2) are the [NaN, Inf] lanes per logical tile (the
    input of the closed forms); ``flags_a`` (ceil(M/BM), ceil(K/BK)) and
    ``flags_b`` (ceil(K/BK), ceil(N/BN)) mark the ``WGMMA_TILE`` operand
    tiles that hold a fatal lane."""
    (bm, bn, bk), consts_a, consts_b, _ = _spec(
        a, b, include_inf, blocks, None, detector
    )
    nan_a, inf_a = common.fatal_masks(a, consts_a)
    nan_b, inf_b = common.fatal_masks(b, consts_b)
    tm, tn, tk = WGMMA_TILE
    return (_tile_sums(nan_a, inf_a, bm, bk).to(torch.int32),
            _tile_sums(nan_b, inf_b, bk, bn).to(torch.int32),
            _tile_flags(nan_a | inf_a, tm, tk), _tile_flags(nan_b | inf_b, tk, tn))


def repair_matmul_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
    blocks: Optional[Tuple[int, int, int]] = None,
    out_dtype: Optional[torch.dtype] = None,
    detector=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`repair_matmul_raw` (any
    device): repair both operands, then ``torch.matmul`` in f32 per logical
    k block, accumulated in f32 in k order as the reference kernel does;
    counts by the closed forms."""
    (bm, bn, bk), consts_a, consts_b, out_dtype = _spec(
        a, b, include_inf, blocks, out_dtype, detector
    )
    fa, nan_a, inf_a = common.repair_tile(a, consts_a, policy, constant,
                                          (bm, bk))
    fb, nan_b, inf_b = common.repair_tile(b, consts_b, policy, constant,
                                          (bk, bn))
    counts = _mm_counts(_tile_sums(nan_a, inf_a, bm, bk),
                       _tile_sums(nan_b, inf_b, bk, bn))
    fa, fb = fa.float(), fb.float()
    acc = torch.matmul(fa[:, :bk], fb[:bk])
    for k0 in range(bk, a.shape[1], bk):
        acc += torch.matmul(fa[:, k0:k0 + bk], fb[k0:k0 + bk])
    return acc.to(out_dtype), counts


_SIGNATURE = [
    _native.P, _native.P, _native.P, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.HOST_INTS, _native.HOST_INTS, _native.U, _native.U,
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.P,
]
_SCAN_SIGNATURE = [
    _native.P, _native.P, _native.I, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.HOST_INTS, _native.HOST_INTS,
    _native.P, _native.P, _native.P, _native.P, _native.P,
]
_WGMMA_SIGNATURE = [
    _native.P, _native.P, _native.P, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.HOST_INTS, _native.HOST_INTS, _native.U, _native.U,
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.P,
    _native.P, _native.P,
]


def _scratch_sizes(M, N, K, blocks):
    """int32 lengths of (counts, tiles_a, tiles_b, flags_a, flags_b)."""
    bm, bn, bk = blocks
    ni, nj, nk = M // bm, N // bn, K // bk
    (fa0, fa1), (fb0, fb1) = _flag_shapes(M, N, K)
    return [8, 2 * ni * nk, 2 * nk * nj, fa0 * fa1, fb0 * fb1]


def _scratch(M, N, K, blocks, dev):
    """One zeroed int32 buffer and the data pointers of its parts (counts,
    tiles_a, tiles_b, flags_a, flags_b); the flags are tiny and there on
    either route."""
    sizes = _scratch_sizes(M, N, K, blocks)
    buf = torch.zeros(sum(sizes), dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    return buf, [base + 4 * o for o in itertools.accumulate([0] + sizes[:-1])]


def _scan_kernel(a, b, blocks, consts_a, consts_b, ptrs):
    """The wgmma route's scan alone, into the parts at ``ptrs`` (from
    :func:`_scratch`): the kernel twin of :func:`scan_plain`, which the
    wgmma route's entry point launches itself."""
    (M, K), N = a.shape, b.shape[1]
    err = _native.function("repair_matmul", "repro_repair_mm_scan",
                           _SCAN_SIGNATURE)(
        a.data_ptr(), b.data_ptr(), common.DTYPE_CODES[a.dtype], M, N, K,
        *blocks, common.host_ints(consts_a), common.host_ints(consts_b),
        *ptrs[1:],
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _native.check(err, "repair_matmul scan")


def _kernel(a, b, blocks, consts_a, consts_b, out_dtype, policy, constant):
    if b.device != a.device:
        raise ValueError(f"repair_matmul: b is on {b.device}, a on {a.device}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"repair_matmul kernel: {name} must be contiguous")
    for t in (a.dtype, b.dtype, out_dtype):
        if t not in common.DTYPE_CODES:
            raise TypeError(f"repair_matmul kernel supports f32/bf16/f16, got {t}")
    (M, K), N = a.shape, b.shape[1]
    dev = a.device
    buf, (counts, tiles_a, tiles_b, flags_a, flags_b) = _scratch(M, N, K, blocks, dev)
    c = torch.empty((M, N), dtype=out_dtype, device=dev)
    codes = common.DTYPE_CODES
    head = (a.data_ptr(), b.data_ptr(), c.data_ptr())
    bm, bn, bk = blocks
    fills_a = tile_fill.table_or_none(policy, a, M, K, (bm, bk), consts_a)
    fills_b = tile_fill.table_or_none(policy, b, K, N, (bk, bn), consts_b)
    dets = (common.host_ints(consts_a), common.host_ints(consts_b),
            common.fill_bits(policy, constant, a.dtype),
            common.fill_bits(policy, constant, b.dtype),
            common.table_ptr(fills_a), common.table_ptr(fills_b))
    stream = torch.cuda.current_stream(dev).cuda_stream
    path = route(a, b)
    if path == "wgmma":          # scan, main kernel and counts
        err = _native.function("repair_matmul", "repro_repair_mm_wgmma",
                               _WGMMA_SIGNATURE)(
            *head, codes[a.dtype], codes[out_dtype], M, N, K, *blocks, *dets,
            tiles_a, tiles_b, flags_a, flags_b, counts, stream,
        )
    else:
        err = _native.function("repair_matmul", "repro_repair_matmul",
                               _SIGNATURE)(
            *head, codes[a.dtype], codes[b.dtype], codes[out_dtype], M, N, K,
            *blocks, *dets, tiles_a, tiles_b, counts, stream,
        )
    _native.check(err, f"repair_matmul ({path})")
    common.LAUNCHES["repair_matmul"] += 1
    return c, buf[:8]


def repair_matmul_raw(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
    blocks: Optional[Tuple[int, int, int]] = None,
    out_dtype: Optional[torch.dtype] = None,
    detector=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(C, counts)``: C = repair(a) @ repair(b) in ``out_dtype`` (default
    a's), counts int32[8].  The operands are not modified (register-mode
    core; ``ops.repair_matmul`` adds the memory-mode origin scrub)."""
    if common.require_device(a, "repair_matmul") == "cpu":
        return repair_matmul_plain(
            a, b, policy=policy, constant=constant, include_inf=include_inf,
            blocks=blocks, out_dtype=out_dtype, detector=detector,
        )
    blocks, consts_a, consts_b, out_dtype = _spec(
        a, b, include_inf, blocks, out_dtype, detector
    )
    return _kernel(a, b, blocks, consts_a, consts_b, out_dtype, policy,
                   constant)
