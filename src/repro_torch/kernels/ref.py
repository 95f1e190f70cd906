"""Plain-tensor oracles of the kernels (twins of the reference's
``kernels/ref.py``): gather, repair per kernel tile, then full softmax.

They replay the kernels' tiling where the counts depend on it (events are
per tile visit), so integer outputs are exact and float outputs agree with
the kernels to allclose.  The wrappers' own plain versions replay the page
walk instead (``kernels.paged_attention``); these oracles are the
independent yardstick the tests hold both against.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core import detect, rules as rules_lib

NEG_INF = -1e30


def _fill(x: torch.Tensor, policy: str, constant: float) -> torch.Tensor:
    if policy == "zero":
        return torch.zeros_like(x)
    if policy == "constant":
        return torch.full_like(x, constant)
    if policy == "clamp_finite_max":
        return torch.full_like(x, torch.finfo(x.dtype).max)
    raise ValueError(policy)


def repair_array_ref(
    x: torch.Tensor, *, policy: str = "zero", constant: float = 0.0,
    include_inf: bool = True, block: Optional[Tuple[int, int]] = None,
):
    """Repair ``x`` tile by tile.  Returns (fixed, nan_count, inf_count,
    tiles_with_fatal) over the trailing-dim-flattened 2-D view."""
    orig = x.shape
    x2 = x.reshape(-1, x.shape[-1]) if x.dim() >= 2 else x.reshape(1, -1)
    rows, cols = x2.shape
    br, bc = block if block is not None else (rows, cols)
    assert rows % br == 0 and cols % bc == 0, (x2.shape, block)
    bits = detect.bits_of(x2)
    nan_m = detect.is_nan_bits(bits, x.dtype)
    inf_m = detect.is_inf_bits(bits, x.dtype)
    mask = (nan_m | inf_m) if include_inf else nan_m
    fixed = torch.where(mask, _fill(x2, policy, constant), x2).reshape(orig)
    tm = mask.reshape(rows // br, br, cols // bc, bc)
    tiles = int(tm.any(dim=3).any(dim=1).sum())
    n_inf = int(inf_m.sum()) if include_inf else 0
    return fixed, int(nan_m.sum()), n_inf, tiles


def scrub_ref(x, *, policy="zero", constant=0.0, include_inf=True, block=None):
    """Oracle of ``kernels.scrub.scrub``: (fixed, [nan, inf, events])."""
    fixed, n, i, ev = repair_array_ref(
        x, policy=policy, constant=constant, include_inf=include_inf,
        block=block,
    )
    return fixed, torch.tensor([n, i, ev], dtype=torch.int32)


def repair_matmul_ref(
    a, b, *, policy="zero", constant=0.0, include_inf=True,
    blocks: Optional[Tuple[int, int, int]] = None, out_dtype=None,
):
    """Oracle of ``repair_matmul_raw``: (c, counts[8]).  Each A tile is
    visited N/bn times and each B tile M/bm times; ``ev_total`` takes the
    closed form over the joint (i, j, k) schedule (the reference's oracle
    leaves it 0).  ``blocks=None`` means one tile per operand."""
    (M, K), N = a.shape, b.shape[1]
    bm, bn, bk = blocks if blocks is not None else (M, N, K)
    ni, nj = M // bm, N // bn
    kw = dict(policy=policy, constant=constant, include_inf=include_inf)
    fa, nan_a, inf_a, ta = repair_array_ref(a, block=(bm, bk), **kw)
    fb, nan_b, inf_b, tb = repair_array_ref(b, block=(bk, bn), **kw)
    c = torch.matmul(fa.float(), fb.float()).to(out_dtype or a.dtype)

    def fatal_tiles(x, br, bc):
        bits = detect.bits_of(x)
        m = detect.is_nan_bits(bits, x.dtype)
        if include_inf:
            m = m | detect.is_inf_bits(bits, x.dtype)
        R, C = x.shape
        return m.reshape(R // br, br, C // bc, bc).any(dim=3).any(dim=1)

    fa_k = fatal_tiles(a, bm, bk).sum(dim=0)        # fatal A tiles per k
    fb_k = fatal_tiles(b, bk, bn).sum(dim=1)        # fatal B tiles per k
    ev_total = int((fa_k * nj + fb_k * ni - fa_k * fb_k).sum())
    counts = torch.tensor([
        nan_a * nj, inf_a * nj, ta * nj, nan_b * ni, inf_b * ni, tb * ni,
        ev_total, 0,
    ], dtype=torch.int32)
    return c, counts


def flash_attention_ref(
    q, k, v, *, causal=True, policy="zero", constant=0.0, include_inf=True,
    kv_block: Optional[int] = None,
):
    """Oracle of ``flash_attention_raw`` as the reference writes it: full
    softmax over the tile-repaired K/V.  Its causal mask is aligned
    bottom-right (``tril(k=T-S)``), the kernels' top-left: the two agree
    only for S == T."""
    B, H, S, D = q.shape
    T = k.shape[2]
    G = H // k.shape[1]
    blk = (kv_block, D) if kv_block else None
    kw = dict(policy=policy, constant=constant, include_inf=include_inf,
              block=blk)
    fk = repair_array_ref(k.reshape(-1, D), **kw)[0].reshape(k.shape)
    fv = repair_array_ref(v.reshape(-1, D), **kw)[0].reshape(v.shape)
    kx = fk.float().repeat_interleave(G, dim=1)
    vx = fv.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kx) / math.sqrt(D)
    if causal:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device).tril(T - S)
        s = torch.where(mask, s, NEG_INF)
    out = torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, dim=-1), vx)
    return out.to(q.dtype)


def _paged_masks(x, detector, include_inf):
    if detector is None:
        z = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        return z, z
    if isinstance(detector, str):          # the "default" sentinel
        detector = rules_lib.Detector(nan=True, inf=include_inf)
    return detector.masks(x)


def _repair_paged_rows(rows, detector, policy, constant, include_inf):
    """Repair (B, M, pg, Kh, Dh) page rows, one (b, m) row per kernel tile;
    returns the repaired rows and per-slot fatal-lane counts (B, M)."""
    nan_m, inf_m = _paged_masks(rows, detector, include_inf)
    mask = nan_m | inf_m
    fixed = torch.where(mask, _fill(rows, policy, constant), rows)
    return fixed, mask.to(torch.int32).sum(dim=(2, 3, 4))


def _operands(policy, constant, policy_k, constant_k, policy_v, constant_v):
    return (
        policy if policy_k is None else policy_k,
        constant if constant_k is None else constant_k,
        policy if policy_v is None else policy_v,
        constant if constant_v is None else constant_v,
    )


def _gather_repair(k_pages, v_pages, bt, layer, det_k, det_v, fills, include_inf):
    if k_pages.dim() == 4:
        k_pages, v_pages = k_pages[:, None], v_pages[:, None]
    pk, ck, pv, cv = fills
    fk, cnt_k = _repair_paged_rows(k_pages[bt, layer], det_k, pk, ck, include_inf)
    fv, cnt_v = _repair_paged_rows(v_pages[bt, layer], det_v, pv, cv, include_inf)
    return fk, fv, cnt_k + cnt_v, k_pages.shape


def paged_attention_ref(
    q, k_pages, v_pages, block_tables, positions, *, layer: int = 0,
    policy="zero", constant=0.0, include_inf=True, detector_k="default",
    detector_v="default", policy_k=None, constant_k=None, policy_v=None,
    constant_v=None,
):
    """Oracle of the paged decode: (out (B, H, Dh), slot_counts (B, M))."""
    bt = block_tables.long()
    fills = _operands(policy, constant, policy_k, constant_k, policy_v, constant_v)
    fk, fv, slot_counts, (P, L, pg, Kh, Dh) = _gather_repair(
        k_pages, v_pages, bt, layer, detector_k, detector_v, fills, include_inf
    )
    B, H, _ = q.shape
    G, M = H // Kh, bt.shape[1]
    T = M * pg
    fk, fv = fk.reshape(B, T, Kh, Dh), fv.reshape(B, T, Kh, Dh)
    qg = q.reshape(B, Kh, G, Dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, fk.float()) / math.sqrt(Dh)
    t = torch.arange(T, device=q.device)
    s = torch.where(t <= positions.long()[:, None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w.to(fv.dtype).float(), fv.float())
    return out.reshape(B, H, Dh).to(q.dtype), slot_counts


def paged_prefill_ref(
    q, k_pages, v_pages, block_tables, q_start, *, layer: int = 0,
    policy="zero", constant=0.0, include_inf=True, detector_k="default",
    detector_v="default", policy_k=None, constant_k=None, policy_v=None,
    constant_v=None,
):
    """Oracle of the chunked-q paged prefill: chunk row ``c`` reads key
    positions ``<= q_start + c``.  (out (B, C, H, Dh), slot_counts)."""
    bt = block_tables.long()
    fills = _operands(policy, constant, policy_k, constant_k, policy_v, constant_v)
    fk, fv, slot_counts, (P, L, pg, Kh, Dh) = _gather_repair(
        k_pages, v_pages, bt, layer, detector_k, detector_v, fills, include_inf
    )
    B, C, H, _ = q.shape
    G, M = H // Kh, bt.shape[1]
    T = M * pg
    fk, fv = fk.reshape(B, T, Kh, Dh), fv.reshape(B, T, Kh, Dh)
    qg = q.reshape(B, C, Kh, G, Dh).float()
    s = torch.einsum("bckgd,btkd->bckgt", qg, fk.float()) / math.sqrt(Dh)
    tq = q_start.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    t = torch.arange(T, device=q.device)
    s = torch.where(t <= tq[:, :, None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bckgt,btkd->bckgd", w.to(fv.dtype).float(), fv.float())
    return out.reshape(B, C, H, Dh).to(q.dtype), slot_counts


def paged_splitk_ref(
    q, k_pages, v_pages, block_tables, positions, *, splits: int,
    layer: int = 0, policy="zero", constant=0.0, include_inf=True,
    detector_k="default", detector_v="default", policy_k=None,
    constant_k=None, policy_v=None, constant_v=None,
):
    """Oracle of split-K decode: per-split softmax partials merged by
    log-sum-exp, a split with no valid position carrying zero weight."""
    bt = block_tables.long()
    fills = _operands(policy, constant, policy_k, constant_k, policy_v, constant_v)
    fk, fv, slot_counts, (P, L, pg, Kh, Dh) = _gather_repair(
        k_pages, v_pages, bt, layer, detector_k, detector_v, fills, include_inf
    )
    B, H, _ = q.shape
    G, M = H // Kh, bt.shape[1]
    assert splits >= 1 and M % splits == 0, (splits, M)
    ns = M // splits
    fk = fk.reshape(B, splits, ns * pg, Kh, Dh)
    fv = fv.reshape(B, splits, ns * pg, Kh, Dh)
    qg = q.reshape(B, Kh, G, Dh).float()
    s = torch.einsum("bkgd,bstkd->bskgt", qg, fk.float()) / math.sqrt(Dh)
    dev = q.device
    t = (
        torch.arange(splits, device=dev)[:, None] * ns * pg
        + torch.arange(ns * pg, device=dev)[None, :]
    )
    valid = t[None, :, None, None, :] <= positions.long()[:, None, None, None, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bskgt,bstkd->bskgd", p.to(fv.dtype).float(), fv.float())
    m_star = m.amax(dim=1)
    w = torch.where(m > -5e29, torch.exp(m - m_star[:, None]), 0.0)
    l_tot = (w * l).sum(dim=1)
    out = (w[..., None] * acc).sum(dim=1) / l_tot.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Dh).to(q.dtype), slot_counts
