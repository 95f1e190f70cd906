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

and tiles that are never live count 0.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core import tiling
from . import _native, common
from .scrub import _fill_bits

NEG_INF = -1e30

# counts layout (int32[8])
NAN_K, INF_K, EV_K, NAN_V, INF_V, EV_V, EV_TOTAL = range(7)

KERNEL_HEAD_DIMS = (64, 128)


def _default_blocks(S: int, T: int) -> Tuple[int, int]:
    """The reference's default logical blocks."""
    return tiling.fit(S, 512), tiling.fit(T, 512)


def _spec(q, k, v, include_inf, blocks, detector):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention needs q (B, H, S, D) and k, v "
                         "(B, Kh, T, D) of one shape")
    B, H, S, D = q.shape
    Bk, Kh, T, Dk = k.shape
    if Bk != B or Dk != D or H % Kh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    bq, bk = blocks if blocks is not None else _default_blocks(S, T)
    if S % bq or T % bk:
        raise ValueError(f"blocks {(bq, bk)} must divide (S, T) = {(S, T)}")
    det = common.resolve_detector(detector, include_inf)
    return ((bq, bk), common.detector_operand(det, k.dtype),
            common.detector_operand(det, v.dtype))


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
    fk, nan_k, inf_k = common.repair_tile(k, consts_k, policy, constant)
    fv, nan_v, inf_v = common.repair_tile(v, consts_v, policy, constant)
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
    _native.U, _native.U, _native.P, _native.P, _native.P,
]


def _kernel(q, k, v, causal, blocks, consts_k, consts_v, policy, constant):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on "
                             f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in common.DTYPE_CODES:
        raise TypeError("flash_attention kernel: q, k and v must share an "
                        "f32/bf16/f16 dtype")
    B, H, S, D = q.shape
    Kh, T = k.shape[1], k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head dims "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    bq, bk = blocks
    scratch = torch.zeros(8 + 4 * B * Kh * (T // bk), dtype=torch.int32,
                          device=q.device)
    counts, tiles = scratch[:8], scratch[8:]
    out = torch.empty_like(q)
    err = _native.function("flash_attention", "repro_flash_attention",
                           _SIGNATURE)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        common.DTYPE_CODES[q.dtype], B, H, Kh, S, T, D, bq, bk, int(causal),
        1.0 / math.sqrt(D), _native.int8_array(consts_k),
        _native.int8_array(consts_v), _fill_bits(policy, constant, k.dtype),
        _fill_bits(policy, constant, v.dtype), tiles.data_ptr(),
        counts.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _native.check(err, "flash_attention")
    common.LAUNCHES["flash_attention"] += 1
    return out, counts


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
