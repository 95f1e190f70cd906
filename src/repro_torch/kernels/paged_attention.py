"""Paged attention with fused on-read repair: decode (serial and split-K)
and chunked-q prefill, straight off the pool.  Kernels:
``csrc/paged_decode.cu`` and ``csrc/paged_prefill.cu``.

Layout (the reference's):

  q             (B, H, Dh) decode / (B, C, H, Dh) prefill
  k/v pages     (P, L, pg, Kh, Dh)  page axis leading; ``layer`` picks L
  block_tables  (B, M) int32        per-request page lists, null-padded
  positions     (B,) int32          last valid position (decode)
  q_start       (B,) int32          context position of chunk row 0 (prefill)

Each (b, j) page visit repairs the page's whole (pg, Kh, Dh) K and V tiles
with the operand's detector and fill and counts them (the page is the
logical tile of ``neighbor_mean``: its mean covers both KV heads, so the
kernels read it from a table over the layer's pages that
``kernels.tile_fill`` writes first): ``slot_counts[b, j]``
is the visit's fatal-lane total and ``counts`` the AT int32[8] layout
[nan_k, inf_k, ev_k, nan_v, inf_v, ev_v, ev_total, 0].  Null-padded slots
are read, repaired and counted on every visit.

The plain versions replay the kernels' page walk (online softmax over the
pages, ``p`` cast to the cache dtype before the value product), vectorised
over the batch; ``kernels.ref`` holds the gather-then-softmax oracles.

Decode routes on the card (:func:`decode_route`, a pure function of the
operands' dtypes, shapes and data pointers, decided before any launch):

  ``"fused"``  q and both pools all f32, bf16 or f16, head dim 64 or 128,
               each contiguous, non-empty and 16-byte aligned, and one
               slot's K and V tiles within a block's shared memory.  One
               native call: a memset of the counts and one launch.  The
               partition is the kernel's own (:func:`fused_partition`):
               request b's M slots go to ceil(M / spb) blocks of spb =
               ceil(M / 8) consecutive slots, which form one thread-block
               cluster.  A block loads all its slots' K and V tiles at once
               (one bulk copy each), repairs them in shared memory and runs
               one warp per query head over its pages; the blocks then
               merge their partials together: each stores the slices of
               its partial into their owners' shared memory (distributed
               shared memory), and each merges its share of the output
               from them in rank order.  The page walk is the
               reference's; ``splits`` keeps its meaning for the plain
               version only; the plain twin of the kernel's partition is
               :func:`paged_decode_fused_plain`.
  ``"walk"``   everything else (the tests' small head dims; offset views;
               StableLM-1.6B's f32 pool, whose slot needs 256 KiB): one
               block per (request, split) walks its slots one after
               another, each page in groups of KV heads
               (:func:`walk_group`), then a second launch merges the
               partials.

Prefill routes on the card (:func:`route`, a pure function of the
operands' dtypes, shapes and data pointers, decided before any launch):

  ``"wgmma"``  q and both pools all bf16 or all f16, head dim 64 or 128,
               page size a multiple of 16 up to 128, each contiguous,
               non-empty, 16-byte aligned and under 2³¹ lanes.  A scan
               kernel reads every slot's K and V once (the counts, and one
               K and one V flag per slot); the main kernel takes 64 of one
               KV head's rows in (C, G) order per block, loads only the
               block's live slots (:func:`live_slots`) by TMA, repairs only
               flagged pages in shared memory, runs the online softmax on
               the tensor cores over tiles of whole pages (up to 128 keys)
               and writes the normalised output.  It rounds the softmax
               weights to the cache dtype before the value product as the
               reference does, but per tile, not per page.
  ``"ffma"``   everything else (f32; the tests' small pages and head dims;
               offset views): unnormalised partials on the FP32 pipe, each
               page staged in groups of KV heads (:func:`ffma_group`), then
               :func:`prefill_normalize`.

A failure on either route raises; neither falls back to the other.  The
walk decode and the FFMA prefill stage a page as f32 in groups of KV
heads, the largest group that fits a block's shared memory, so they take
every pool of the registry; only a pool where not even one KV head's page
fits a block is refused before any launch (:func:`smem_refusal`,
:func:`pool_refusal`).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from . import _native, common, tile_fill

NEG_INF = -1e30

# counts layout (int32[8])
NAN_K, INF_K, EV_K, NAN_V, INF_V, EV_V, EV_TOTAL = range(7)

# detector sentinel: "the legacy NaN(+Inf) pattern via include_inf".
# ``None`` means detection off for that operand.
DEFAULT_DETECTOR = "default"


# the wgmma prefill route's main kernel (csrc/paged_prefill.cu, namespace
# pw): blocks of WGMMA_ROWS of one KV head's (C, G) rows, K/V tiles of
# WGMMA_KEYS keys (whole pages)
WGMMA_ROWS = 64
WGMMA_KEYS = 128
_WGMMA_DTYPES = (torch.bfloat16, torch.float16)
_WGMMA_HEAD_DIMS = (64, 128)
_WGMMA_MAX_LANES = 1 << 31     # csrc: pw::shape_ok


# a block's dynamic shared memory on the H100 (227 KB), every route's cap
BLOCK_SMEM = 232448
# the fused decode route (csrc/paged_decode.cu, namespace fd): clusters of
# at most FUSED_MAX_CLUSTER blocks
FUSED_MAX_CLUSTER = 8
# the FFMA prefill's q rows a block (csrc/paged_prefill.cu: kRows)
FFMA_ROWS = 16
_FUSED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_FUSED_HEAD_DIMS = (64, 128)


@functools.lru_cache(maxsize=None)
def _consts(det, dtype, include_inf):
    if det == DEFAULT_DETECTOR:
        det = common.resolve_detector(None, include_inf)
    return common.detector_operand(det, dtype)


def _operand_spec(dtype, include_inf, policy, constant, detector_k,
                  detector_v, policy_k, constant_k, policy_v, constant_v):
    """(consts_k, consts_v, (policy_k, constant_k), (policy_v, constant_v))."""
    fill_k = (policy if policy_k is None else policy_k,
              constant if constant_k is None else constant_k)
    fill_v = (policy if policy_v is None else policy_v,
              constant if constant_v is None else constant_v)
    return (_consts(detector_k, dtype, include_inf),
            _consts(detector_v, dtype, include_inf), fill_k, fill_v)


# ----------------------------------------------------------------- plain
def _repair_visits(pages, bt, layer, consts, fill):
    """Repaired (B, M, pg, Kh, Dh) rows of every page visit, with per-visit
    NaN and Inf lane counts (B, M); a visit's page is one logical tile."""
    rows = pages[bt.long(), layer]
    pg, kh, dh = rows.shape[2:]
    fixed, nan_m, inf_m = common.repair_tile(rows, consts, *fill, (pg * kh, dh))
    return fixed, nan_m.sum(dim=(2, 3, 4)), inf_m.sum(dim=(2, 3, 4))


def _visit_counts(nk, ik, nv, iv):
    """slot_counts (B, M) and the AT counts of a set of page visits."""
    fk, fv = nk + ik, nv + iv
    counts = torch.stack([
        nk.sum(), ik.sum(), (fk > 0).sum(), nv.sum(), iv.sum(), (fv > 0).sum(),
        ((fk + fv) > 0).sum(), torch.zeros((), dtype=nk.dtype, device=nk.device),
    ]).to(torch.int32)
    return (fk + fv).to(torch.int32), counts


def _online_step(s, m, l, acc, v, out_dtype_p):
    """One page of the online softmax.  ``s`` (..., t) masked scores,
    ``v`` (..., t, d) values in the cache dtype."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m_new[..., None]), 0.0)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    pv = torch.matmul(p.to(out_dtype_p).float(), v.float())
    return m_new, l, acc * alpha[..., None] + pv


def _decode_plain(q, k_pages, v_pages, bt, pos, layer, ns, spec):
    """The page walk in groups of ``ns`` consecutive slots (the last group
    may be shorter), each an online softmax page by page from its own
    running max, merged by :func:`lse_merge`.  ``ns = M // splits`` is the
    reference's split-K walk; a short last group is padded with slots that
    are masked, hold zeros and are not counted, so it leaves (m, l, acc)
    exactly as they were."""
    consts_k, consts_v, fill_k, fill_v = spec
    B, H, Dh = q.shape
    P, L, pg, Kh, _ = k_pages.shape
    G, M = H // Kh, bt.shape[1]
    splits = -(-M // ns)
    fk, nk, ik = _repair_visits(k_pages, bt, layer, consts_k, fill_k)
    fv, nv, iv = _repair_visits(v_pages, bt, layer, consts_v, fill_v)
    slot_counts, counts = _visit_counts(nk, ik, nv, iv)
    if splits * ns > M:
        pad = fk.new_zeros((B, splits * ns - M) + fk.shape[2:])
        fk, fv = torch.cat([fk, pad], dim=1), torch.cat([fv, pad], dim=1)
    # (B, S, ns, Kh, pg, Dh): split s walks slots s*ns .. s*ns + ns - 1
    fk = fk.reshape(B, splits, ns, pg, Kh, Dh).transpose(3, 4).float()
    fv = fv.reshape(B, splits, ns, pg, Kh, Dh).transpose(3, 4)
    qg = q.float().reshape(B, 1, Kh, G, Dh)
    sm_scale = 1.0 / math.sqrt(Dh)
    acc = q.new_zeros((B, splits, Kh, G, Dh), dtype=torch.float32)
    m = torch.full((B, splits, Kh, G), NEG_INF, device=q.device)
    l = torch.zeros((B, splits, Kh, G), device=q.device)
    base = torch.arange(splits, device=q.device)[:, None] * ns
    for jj in range(ns):
        s = torch.matmul(qg, fk[:, :, jj].transpose(-1, -2)) * sm_scale
        j = base + jj                                            # (S, 1)
        t = j * pg + torch.arange(pg, device=q.device)           # (S, pg)
        valid = ((t[None, :, None, None, :] <= pos.long()[:, None, None, None, None])
                 & (j < M)[None, :, None, None, :])
        s = torch.where(valid, s, NEG_INF)
        m, l, acc = _online_step(s, m, l, acc, fv[:, :, jj], v_pages.dtype)
    out = lse_merge(q.dtype, acc.reshape(B, splits, H, Dh),
                    m.reshape(B, splits, H), l.reshape(B, splits, H))
    return out, slot_counts, counts


def lse_merge(out_dtype, o_part, m_part, l_part):
    """Log-sum-exp merge of unnormalised partials along axis 1; a partial
    whose slice held no valid position (m = -inf) gets zero weight."""
    m_star = m_part.amax(dim=1)
    live = m_part > NEG_INF * 0.5
    w = torch.where(live, torch.exp(m_part - m_star[:, None, :]), 0.0)
    l_tot = (w * l_part).sum(dim=1)
    acc = (w[..., None] * o_part).sum(dim=1)
    return (acc / l_tot.clamp_min(1e-30)[..., None]).to(out_dtype)


def _prefill_plain(q, k_pages, v_pages, bt, q_start, layer, spec):
    consts_k, consts_v, fill_k, fill_v = spec
    B, C, H, Dh = q.shape
    P, L, pg, Kh, _ = k_pages.shape
    G, M = H // Kh, bt.shape[1]
    fk, nk, ik = _repair_visits(k_pages, bt, layer, consts_k, fill_k)
    fv, nv, iv = _repair_visits(v_pages, bt, layer, consts_v, fill_v)
    slot_counts, counts = _visit_counts(nk, ik, nv, iv)
    fk = fk.transpose(2, 3).float()                    # (B, M, Kh, pg, Dh)
    fv = fv.transpose(2, 3)
    # rows in (Kh, C, G) order per KV head: (B, Kh, C*G, Dh)
    qh = q.float().reshape(B, C, Kh, G, Dh).permute(0, 2, 1, 3, 4)
    qh = qh.reshape(B, Kh, C * G, Dh)
    sm_scale = 1.0 / math.sqrt(Dh)
    acc = q.new_zeros((B, Kh, C * G, Dh), dtype=torch.float32)
    m = torch.full((B, Kh, C * G), NEG_INF, device=q.device)
    l = torch.zeros((B, Kh, C * G), device=q.device)
    tq = q_start.long()[:, None] + torch.arange(C, device=q.device)
    tq = tq.repeat_interleave(G, dim=1)[:, None, :, None]   # (B, 1, C*G, 1)
    for j in range(M):
        s = torch.matmul(qh, fk[:, j].transpose(-1, -2)) * sm_scale
        tk = j * pg + torch.arange(pg, device=q.device)
        s = torch.where(tk <= tq, s, NEG_INF)
        m, l, acc = _online_step(s, m, l, acc, fv[:, j], v_pages.dtype)

    def rows(x):                       # (B, Kh, C*G, ...) -> (B, C*H, ...)
        x = x.reshape(B, Kh, C, G, *x.shape[3:]).transpose(1, 2)
        return x.reshape(B, C * H, *x.shape[4:])

    acc = rows(acc).reshape(B, C, H, Dh)
    return acc, rows(m), rows(l), slot_counts, counts


def route(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor) -> str:
    """``"wgmma"`` or ``"ffma"``: which CUDA kernels take a prefill call
    (the rule in the module docstring)."""
    ops = (q, k_pages, v_pages)
    if (q.dtype == k_pages.dtype == v_pages.dtype and q.dtype in _WGMMA_DTYPES
            and q.dim() == 4 and k_pages.dim() == 5
            and q.shape[-1] in _WGMMA_HEAD_DIMS
            and k_pages.shape[2] % 16 == 0 and k_pages.shape[2] <= WGMMA_KEYS
            and all(0 < t.numel() < _WGMMA_MAX_LANES for t in ops)
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ops)):
        return "wgmma"
    return "ffma"


def fused_partition(M: int) -> Tuple[int, int]:
    """``(nb, spb)``: the fused decode route's blocks per request and slots
    per block, ``spb = ceil(M / 8)`` consecutive slots a block and ``nb =
    ceil(M / spb)`` blocks (one thread-block cluster a request; the last
    block may hold fewer slots)."""
    spb = -(-M // min(M, FUSED_MAX_CLUSTER))
    return -(-M // spb), spb


def fused_smem(H: int, Dh: int, pg: int, Kh: int, itemsize: int) -> int:
    """Dynamic shared-memory bytes of a fused decode block that stages one
    slot: q, the slot's K and V tiles, the block's own partial (acc, m, l),
    its inbox for the merge (its share of every block's acc, at most one
    partial's acc and 8 float4s, and (m, l) of every head from each of
    FUSED_MAX_CLUSTER blocks), a page's scores per head and the slot's
    counts (csrc: ``fd::Layout``)."""
    tile = pg * Kh * Dh * itemsize
    inbox = 4 * H * Dh + 16 * FUSED_MAX_CLUSTER + 8 * FUSED_MAX_CLUSTER * H
    return (16 + H * Dh * itemsize + 2 * tile + 4 * H * (Dh + 2) + inbox
            + 4 * H * pg + 16)


def decode_route(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor) -> str:
    """``"fused"`` or ``"walk"``: which CUDA kernels take a decode call
    (the rule in the module docstring)."""
    ops = (q, k_pages, v_pages)
    if (q.dtype == k_pages.dtype == v_pages.dtype and q.dtype in _FUSED_DTYPES
            and q.dim() == 3 and k_pages.dim() == 5
            and k_pages.shape == v_pages.shape
            and q.shape[-1] == k_pages.shape[-1] in _FUSED_HEAD_DIMS
            and all(t.numel() > 0 for t in ops)
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ops)):
        H, Dh = q.shape[1:]
        pg, Kh = k_pages.shape[2:4]
        if fused_smem(H, Dh, pg, Kh, q.element_size()) <= BLOCK_SMEM:
            return "fused"
    return "walk"


def walk_smem(H: int, Dh: int, pg: int, Kh: int, kg: int) -> int:
    """Dynamic shared-memory bytes of a walk decode block that stages a
    page ``kg`` KV heads at a time: q and the accumulator of every head,
    the group's K (padded rows) and V tiles as f32, a page's scores of the
    group's query heads, the running m, l and scale per head, the counts
    (the layout of csrc/paged_decode.cu's ``decode_partials``, which takes
    these bytes from the wrapper)."""
    rows = pg * kg
    return 4 * (2 * H * Dh + rows * (2 * Dh + 1) + kg * (H // Kh) * pg
                + 3 * H) + 16


def ffma_smem(Dh: int, pg: int, kg: int) -> int:
    """Dynamic shared-memory bytes of an FFMA prefill block that stages a
    page ``kg`` KV heads at a time: its FFMA_ROWS q rows (padded) and
    accumulators, the group's K (padded rows) and V tiles as f32, the
    rows' scores and running m, l and scale, the counts
    (the layout of csrc/paged_prefill.cu's ``prefill_partials``, which
    takes these bytes from the wrapper)."""
    rows, r = pg * kg, FFMA_ROWS
    return 4 * (r * (Dh + 1) + rows * (2 * Dh + 1) + r * Dh + r * pg
                + 3 * r) + 16


def _largest_group(smem, Kh: int) -> int:
    return next((kg for kg in range(Kh, 0, -1) if smem(kg) <= BLOCK_SMEM), 0)


def walk_group(H: int, Dh: int, pg: int, Kh: int) -> int:
    """KV heads a walk decode block stages at a time: the most, up to
    ``Kh``, whose :func:`walk_smem` fits BLOCK_SMEM; 0 when not even one
    KV head's page fits.  The wrapper passes it and its bytes to the
    kernel's launch."""
    return _largest_group(lambda kg: walk_smem(H, Dh, pg, Kh, kg), Kh)


def ffma_group(Dh: int, pg: int, Kh: int) -> int:
    """KV heads an FFMA prefill block stages at a time, as
    :func:`walk_group`."""
    return _largest_group(lambda kg: ffma_smem(Dh, pg, kg), Kh)


def smem_refusal(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor) -> Optional[str]:
    """Why the card cannot take this call: the route :func:`decode_route`
    (a 3-D q) or :func:`route` (a 4-D q) picks stages a page in groups of
    KV heads, and not even one KV head's page fits BLOCK_SMEM; ``None``
    where it does."""
    H, Dh = q.shape[-2:]
    pg, Kh = k_pages.shape[2:4]
    if q.dim() == 3:
        if (decode_route(q, k_pages, v_pages) == "fused"
                or walk_group(H, Dh, pg, Kh)):
            return None
        what, need = "paged decode (walk route)", walk_smem(H, Dh, pg, Kh, 1)
    else:
        if route(q, k_pages, v_pages) == "wgmma" or ffma_group(Dh, pg, Kh):
            return None
        what, need = "paged prefill (ffma route)", ffma_smem(Dh, pg, 1)
    return (f"{what} needs {need} B of shared memory a block for one KV "
            f"head's page, over the {BLOCK_SMEM} B a block has, at {H} heads "
            f"of {Dh} on pages of {pg} x {Kh} KV heads in "
            f"{str(q.dtype).split('.')[-1]}")


def pool_refusal(n_heads: int, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 prefill: bool = True) -> Optional[str]:
    """:func:`smem_refusal` of the decode (and, with ``prefill``, the
    prefill) a contiguous q of ``n_heads`` heads takes on these pools;
    ``None`` where the card can run both."""
    Dh = k_pages.shape[-1]
    shapes = [(1, n_heads, Dh)] + ([(1, 1, n_heads, Dh)] if prefill else [])
    why = [smem_refusal(torch.empty(s, dtype=k_pages.dtype, device=k_pages.device),
                        k_pages, v_pages) for s in shapes]
    return "; ".join(w for w in why if w) or None


def _check_smem(q, k_pages, v_pages):
    why = smem_refusal(q, k_pages, v_pages)
    if why:
        raise ValueError(f"{why} (ROADMAP.md §3)")


def live_slots(q_start, C: int, G: int, pg: int, M: int,
               flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """How many leading block-table slots each row block of the wgmma
    route loads, (B, ceil(C·G / WGMMA_ROWS)) int64: slot j is live for a
    block iff ``j·pg <= q_start[b] + c``, c the chunk row of the block's
    last row.  The other slots' keys are masked for every row of the
    block.  With the scan's ``flags`` (:func:`prefill_scan_plain`), a block
    also loads every slot up to its request's last one whose V stays
    non-finite after the repair (bit 1 of the V flag): its 0 × NaN reaches
    the masked rows, as in the reference (csrc: ``key_end``)."""
    n = -(-C * G // WGMMA_ROWS)
    last = torch.clamp((torch.arange(n) + 1) * WGMMA_ROWS, max=C * G) - 1
    qs = torch.as_tensor(q_start).long().cpu().reshape(-1, 1)
    live = torch.clamp((qs + last[None] // G) // pg + 1, max=M)
    if flags is None:
        return live
    poison = (flags[..., 1].long().cpu() >> 1) & 1               # (B, M)
    end = (poison * torch.arange(1, M + 1)).amax(dim=1, keepdim=True)
    return torch.maximum(live, end)


def prefill_scan_plain(
    k_pages, v_pages, block_tables, layer, *, include_inf: bool = True,
    detector_k=DEFAULT_DETECTOR, detector_v=DEFAULT_DETECTOR,
    policy_v: str = "zero", constant_v: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the wgmma route's scan kernel: every (b, j)
    slot's K and V tiles at ``layer`` classified, null-padded slots and
    slots past every row's causal limit included.  Returns ``(slot_counts
    (B, M), counts int32[8], flags (B, M, 2))``, ``flags`` [K, V] int32:
    bit 0 where the slot's tile holds a fatal lane, and bit 1 of V where
    the V tile stays non-finite after the repair with the V fill (a lane
    the V detector lets through, or a non-finite fill)."""
    bt, layer = block_tables, int(layer)
    _, nk, ik = _repair_visits(k_pages, bt, layer,
                               _consts(detector_k, k_pages.dtype, include_inf),
                               ("zero", 0.0))
    fixed_v, nv, iv = _repair_visits(
        v_pages, bt, layer, _consts(detector_v, v_pages.dtype, include_inf),
        (policy_v, constant_v))
    slot_counts, counts = _visit_counts(nk, ik, nv, iv)
    poison = (~torch.isfinite(fixed_v)).flatten(2).any(dim=-1)
    flags = torch.stack([(nk + ik > 0).int(),
                         (nv + iv > 0).int() | (poison.int() << 1)], dim=-1)
    return slot_counts, counts, flags.to(torch.int32)


# ---------------------------------------------------------------- kernels
_DECODE_SIG = [
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.HOST_INTS, _native.HOST_INTS, _native.U, _native.U, _native.P,
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.P,
    _native.P, _native.P,
]
_PREFILL_SIG = [
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.HOST_INTS, _native.HOST_INTS, _native.U, _native.U, _native.P,
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.P,
    _native.P,
]

_PREFILL_WGMMA_SIG = [
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.HOST_INTS,
    _native.HOST_INTS, _native.U, _native.U, _native.P, _native.P,
    _native.P, _native.P, _native.P, _native.P, _native.P,
]
_DECODE_FUSED_SIG = [
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.HOST_INTS, _native.HOST_INTS,
    _native.U, _native.U, _native.P, _native.P, _native.P, _native.P,
    _native.P, _native.P,
]
_SCAN_SIG = [
    _native.P, _native.P, _native.P, _native.I, _native.I, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.HOST_INTS, _native.HOST_INTS, _native.U, _native.P, _native.P,
    _native.P, _native.P, _native.P,
]


def _pool_tables(k_pages, v_pages, layer, spec):
    """The ``neighbor_mean`` fill tables of K and V over every page of the
    layer (indexed by page id), each None unless its operand's policy is
    ``neighbor_mean`` with a detector that repairs."""
    consts_k, consts_v, fill_k, fill_v = spec
    P, L, pg, Kh, Dh = k_pages.shape
    cols = pg * Kh * Dh
    where = dict(row_stride=L * cols, offset=int(layer) * cols)
    return (tile_fill.table_or_none(fill_k[0], k_pages, P, cols, (1, cols),
                                    consts_k, **where),
            tile_fill.table_or_none(fill_v[0], v_pages, P, cols, (1, cols),
                                    consts_v, **where))


def _check_operands(q, k_pages, v_pages, bt, vec, what):
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", bt), ("positions", vec)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if k_pages.shape != v_pages.shape or k_pages.dtype != v_pages.dtype:
        raise ValueError(f"{what}: k/v pages differ in shape or dtype")
    if q.dtype != k_pages.dtype or q.dtype not in common.DTYPE_CODES:
        raise TypeError(f"{what}: q and pages must share an f32/bf16/f16 dtype")
    if bt.dtype != torch.int32 or vec.dtype != torch.int32:
        raise TypeError(f"{what}: block tables and positions must be int32")


def _decode_kernel(q, k_pages, v_pages, bt, pos, layer, splits, spec):
    consts_k, consts_v, fill_k, fill_v = spec
    _check_operands(q, k_pages, v_pages, bt, pos, "paged decode")
    _check_smem(q, k_pages, v_pages)
    B, H, Dh = q.shape
    P, L, pg, Kh, _ = k_pages.shape
    M = bt.shape[1]
    dev = q.device
    o_part = torch.empty((B, splits, H, Dh), dtype=torch.float32, device=dev)
    m_part = torch.empty((B, splits, H), dtype=torch.float32, device=dev)
    l_part = torch.empty((B, splits, H), dtype=torch.float32, device=dev)
    slot_counts = torch.empty((B, M), dtype=torch.int32, device=dev)
    counts = torch.zeros(8, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    fills_k, fills_v = _pool_tables(k_pages, v_pages, layer, spec)
    kg = walk_group(H, Dh, pg, Kh)
    err = _native.function("paged_decode", "repro_paged_decode",
                           _DECODE_SIG)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
        pos.data_ptr(), common.DTYPE_CODES[q.dtype], B, H, Dh, L, pg, Kh, kg,
        walk_smem(H, Dh, pg, Kh, kg), M, splits, int(layer), _native.int8_array(consts_k), _native.int8_array(consts_v),
        common.fill_bits(*fill_k, q.dtype), common.fill_bits(*fill_v, q.dtype),
        common.table_ptr(fills_k), common.table_ptr(fills_v),
        o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
        slot_counts.data_ptr(), counts.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _native.check(err, "paged decode")
    common.LAUNCHES["paged_decode"] += 1
    return out, slot_counts, counts


def _prefill_kernel(q, k_pages, v_pages, bt, q_start, layer, spec):
    consts_k, consts_v, fill_k, fill_v = spec
    _check_operands(q, k_pages, v_pages, bt, q_start, "paged prefill")
    _check_smem(q, k_pages, v_pages)
    B, C, H, Dh = q.shape
    P, L, pg, Kh, _ = k_pages.shape
    M = bt.shape[1]
    dev = q.device
    acc = torch.empty((B, C, H, Dh), dtype=torch.float32, device=dev)
    m = torch.empty((B, C * H), dtype=torch.float32, device=dev)
    l = torch.empty((B, C * H), dtype=torch.float32, device=dev)
    slot_counts = torch.empty((B, M), dtype=torch.int32, device=dev)
    counts = torch.zeros(8, dtype=torch.int32, device=dev)
    fills_k, fills_v = _pool_tables(k_pages, v_pages, layer, spec)
    kg = ffma_group(Dh, pg, Kh)
    err = _native.function("paged_prefill", "repro_paged_prefill",
                           _PREFILL_SIG)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
        q_start.data_ptr(), common.DTYPE_CODES[q.dtype], B, C, H, Dh, L, pg, Kh,
        kg, ffma_smem(Dh, pg, kg), M, int(layer), _native.int8_array(consts_k), _native.int8_array(consts_v),
        common.fill_bits(*fill_k, q.dtype), common.fill_bits(*fill_v, q.dtype),
        common.table_ptr(fills_k), common.table_ptr(fills_v),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), slot_counts.data_ptr(),
        counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _native.check(err, "paged prefill")
    common.LAUNCHES["paged_prefill"] += 1
    return acc, m, l, slot_counts, counts


@functools.lru_cache(maxsize=64)
def _pool_constants(what, k_shape, v_shape, dtype, include_inf, policy,
                    constant, detector_k, detector_v, policy_k, constant_k,
                    policy_v, constant_v):
    """What repeats across the wgmma prefill's and the fused decode's calls
    on one pool, cached by value: the pool's shape, then the detector
    operands and fill bits, and the operand spec when a fill is
    ``neighbor_mean`` (its tables are data: each call writes them), else
    None."""
    if v_shape != k_shape:
        raise ValueError(f"{what}: k pages {tuple(k_shape)}, v pages "
                         f"{tuple(v_shape)}")
    spec = _operand_spec(
        dtype, include_inf, policy, constant, detector_k, detector_v,
        policy_k, constant_k, policy_v, constant_v)
    ck, cv, fill_k, fill_v = spec
    nm = "neighbor_mean" in (fill_k[0], fill_v[0])
    return k_shape, (common.host_ints(ck), common.host_ints(cv),
                     common.fill_bits(*fill_k, dtype),
                     common.fill_bits(*fill_v, dtype)), spec if nm else None


def _check_tables(q, bt, vec, what="paged prefill", vec_name="q_start"):
    for name, t in (("block_tables", bt), (vec_name, vec)):
        if t.device != q.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int32 "
                             f"on {q.device}")


def _prefill_wgmma(q, k_pages, v_pages, bt, q_start, layer, include_inf, fills):
    """The wgmma route: one native call zeroes the counts and launches the
    scan and the main kernel.  One int32 buffer holds counts (8), the
    scan's per-request poison ends (B), slot_counts (B, M) and its flags
    (B, M, 2)."""
    _check_tables(q, bt, q_start)
    (P, L, pg, Kh, Dk), tail, nm_spec = _pool_constants(
        "paged prefill", k_pages.shape, v_pages.shape, q.dtype, include_inf,
        **fills)
    B, C, H, Dh = q.shape
    if (Dk != Dh or H % Kh or bt.dim() != 2 or bt.shape[0] != B
            or bt.shape[1] < 1 or q_start.shape != (B,)):
        raise ValueError(f"paged prefill: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, block tables "
                         f"{tuple(bt.shape)} and q_start "
                         f"{tuple(q_start.shape)} do not fit")
    layer, M = int(layer), bt.shape[1]
    if not 0 <= layer < L:
        raise IndexError(f"paged prefill: layer {layer} of a {L}-layer pool")
    head = 8 + B
    buf = torch.empty(head + 3 * B * M, dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    base = buf.data_ptr()
    tables = ((None, None) if nm_spec is None
              else _pool_tables(k_pages, v_pages, layer, nm_spec))
    err = _native.function("paged_prefill", "repro_paged_prefill_wgmma",
                           _PREFILL_WGMMA_SIG)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
        q_start.data_ptr(), common.DTYPE_CODES[q.dtype], B, C, H, Dh, P, L,
        pg, Kh, M, layer, *tail, *map(common.table_ptr, tables),
        out.data_ptr(), base + 4 * head,
        base + 4 * (head + B * M), base, common.raw_stream(q.device),
    )
    _native.check(err, "paged prefill (wgmma)")
    common.LAUNCHES["paged_prefill"] += 1
    return out, buf[head:head + B * M].view(B, M), buf[:8]


def _decode_fused(q, k_pages, v_pages, bt, pos, layer, include_inf, fills):
    """The fused route: one native call zeroes the counts and launches
    ``decode_fused``.  One int32 buffer holds counts (8) and slot_counts
    (B, M)."""
    _check_tables(q, bt, pos, "paged decode", "positions")
    (P, L, pg, Kh, Dk), tail, nm_spec = _pool_constants(
        "paged decode", k_pages.shape, v_pages.shape, q.dtype, include_inf,
        **fills)
    B, H, Dh = q.shape
    if (Dk != Dh or H % Kh or bt.dim() != 2 or bt.shape[0] != B
            or bt.shape[1] < 1 or pos.shape != (B,)):
        raise ValueError(f"paged decode: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, block tables "
                         f"{tuple(bt.shape)} and positions "
                         f"{tuple(pos.shape)} do not fit")
    layer, M = int(layer), bt.shape[1]
    if not 0 <= layer < L:
        raise IndexError(f"paged decode: layer {layer} of a {L}-layer pool")
    buf = torch.empty(8 + B * M, dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    base = buf.data_ptr()
    tables = ((None, None) if nm_spec is None
              else _pool_tables(k_pages, v_pages, layer, nm_spec))
    err = _native.function("paged_decode", "repro_paged_decode_fused",
                           _DECODE_FUSED_SIG)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
        pos.data_ptr(), common.DTYPE_CODES[q.dtype], B, H, Dh, P, L, pg, Kh,
        M, layer, *tail, *map(common.table_ptr, tables), out.data_ptr(),
        base + 32, base,
        common.raw_stream(q.device),
    )
    _native.check(err, "paged decode (fused)")
    common.LAUNCHES["paged_decode"] += 1
    return out, buf[8:].view(B, M), buf[:8]


def _scan_kernel(k_pages, v_pages, block_tables, layer, *, include_inf=True,
                 detector_k=DEFAULT_DETECTOR, detector_v=DEFAULT_DETECTOR,
                 policy_v="zero", constant_v=0.0):
    """The wgmma route's scan kernel alone, the twin of
    :func:`prefill_scan_plain` (which the route's entry point launches
    itself): ``(slot_counts, counts, flags, poison_end)``, ``poison_end``
    (B,) the end of each request's last slot with bit 1 of its V flag."""
    bt = block_tables
    P, L, pg, Kh, Dh = k_pages.shape
    B, M = bt.shape
    dev = k_pages.device
    slot_counts = torch.empty((B, M), dtype=torch.int32, device=dev)
    flags = torch.empty((B, M, 2), dtype=torch.int32, device=dev)
    counts = torch.empty(8 + B, dtype=torch.int32, device=dev)
    consts_v = _consts(detector_v, v_pages.dtype, include_inf)
    fills_v = _pool_tables(k_pages, v_pages, layer,
                           (consts_v, consts_v, ("zero", 0.0),
                            (policy_v, constant_v)))[1]
    err = _native.function("paged_prefill", "repro_paged_prefill_scan",
                           _SCAN_SIG)(
        k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
        common.DTYPE_CODES[k_pages.dtype], B, M, P, L, pg, Kh, Dh, int(layer),
        common.host_ints(_consts(detector_k, k_pages.dtype, include_inf)),
        common.host_ints(_consts(detector_v, v_pages.dtype, include_inf)),
        common.fill_bits(policy_v, constant_v, v_pages.dtype),
        common.table_ptr(fills_v),
        slot_counts.data_ptr(), flags.data_ptr(), counts.data_ptr(),
        common.raw_stream(dev),
    )
    _native.check(err, "paged prefill scan")
    return slot_counts, counts[:8], flags, counts[8:]


# --------------------------------------------------------------- wrappers
def _check_splits(block_tables, splits):
    M = block_tables.shape[1]
    if splits < 1 or M % splits:
        raise ValueError(f"splits={splits} must divide the block-table width M={M}")


def _decode_spec(q, k_pages, block_tables, splits, include_inf, fills):
    H = q.shape[1]
    if H % k_pages.shape[3]:
        raise ValueError(f"H={H} is not a multiple of Kh={k_pages.shape[3]}")
    _check_splits(block_tables, splits)
    return _operand_spec(q.dtype, include_inf, **fills)


def paged_decode_plain(
    q, k_pages, v_pages, block_tables, positions, layer, *, splits: int = 1,
    policy: str = "zero", constant: float = 0.0, include_inf: bool = True,
    detector_k=DEFAULT_DETECTOR, detector_v=DEFAULT_DETECTOR,
    policy_k: Optional[str] = None, constant_k: Optional[float] = None,
    policy_v: Optional[str] = None, constant_v: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the decode kernel (any device)."""
    spec = _decode_spec(q, k_pages, block_tables, splits, include_inf, dict(
        policy=policy, constant=constant, detector_k=detector_k,
        detector_v=detector_v, policy_k=policy_k, constant_k=constant_k,
        policy_v=policy_v, constant_v=constant_v,
    ))
    return _decode_plain(q, k_pages, v_pages, block_tables, positions,
                         int(layer), block_tables.shape[1] // splits, spec)


def paged_decode_fused_plain(
    q, k_pages, v_pages, block_tables, positions, layer, *,
    policy: str = "zero", constant: float = 0.0, include_inf: bool = True,
    detector_k=DEFAULT_DETECTOR, detector_v=DEFAULT_DETECTOR,
    policy_k: Optional[str] = None, constant_k: Optional[float] = None,
    policy_v: Optional[str] = None, constant_v: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain twin of the fused decode route's partition
    (:func:`fused_partition`): the same page walk as
    :func:`paged_decode_plain`, in groups of ``spb`` consecutive slots."""
    spec = _decode_spec(q, k_pages, block_tables, 1, include_inf, dict(
        policy=policy, constant=constant, detector_k=detector_k,
        detector_v=detector_v, policy_k=policy_k, constant_k=constant_k,
        policy_v=policy_v, constant_v=constant_v,
    ))
    spb = fused_partition(block_tables.shape[1])[1]
    return _decode_plain(q, k_pages, v_pages, block_tables, positions,
                         int(layer), spb, spec)


def _decode(q, k_pages, v_pages, block_tables, positions, layer, splits,
            include_inf, **fills):
    if common.require_device(q, "paged decode", k_pages, v_pages) == "cpu":
        return paged_decode_plain(
            q, k_pages, v_pages, block_tables, positions, layer,
            splits=splits, include_inf=include_inf, **fills,
        )
    if decode_route(q, k_pages, v_pages) == "fused":
        _check_splits(block_tables, splits)
        return _decode_fused(q, k_pages, v_pages, block_tables, positions,
                             layer, include_inf, fills)
    spec = _decode_spec(q, k_pages, block_tables, splits, include_inf, fills)
    return _decode_kernel(q, k_pages, v_pages, block_tables, positions, layer,
                          splits, spec)


def paged_attention_raw(
    q, k_pages, v_pages, block_tables, positions, layer, *,
    policy: str = "zero", constant: float = 0.0, include_inf: bool = True,
    detector_k=DEFAULT_DETECTOR, detector_v=DEFAULT_DETECTOR,
    policy_k: Optional[str] = None, constant_k: Optional[float] = None,
    policy_v: Optional[str] = None, constant_v: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer of serial paged decode with fused on-read repair.
    ``detector_k``/``detector_v``: a ``core.rules.Detector``, the default
    sentinel, or ``None`` (detection off for that operand).  Per-operand
    fills override the shared ``policy``/``constant``.  Returns
    ``(out (B, H, Dh), slot_counts (B, M) int32, counts int32[8])``."""
    return _decode(
        q, k_pages, v_pages, block_tables, positions, layer, 1, include_inf,
        policy=policy, constant=constant, detector_k=detector_k,
        detector_v=detector_v, policy_k=policy_k, constant_k=constant_k,
        policy_v=policy_v, constant_v=constant_v,
    )


def paged_attention_splitk_raw(
    q, k_pages, v_pages, block_tables, positions, layer, *, splits: int,
    policy: str = "zero", constant: float = 0.0, include_inf: bool = True,
    detector_k=DEFAULT_DETECTOR, detector_v=DEFAULT_DETECTOR,
    policy_k: Optional[str] = None, constant_k: Optional[float] = None,
    policy_v: Optional[str] = None, constant_v: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-K paged decode: the M slots cut into ``splits`` contiguous
    groups, each an unnormalised partial, merged by log-sum-exp.  Counts
    are identical to the serial walk's (every slot is visited once)."""
    return _decode(
        q, k_pages, v_pages, block_tables, positions, layer, splits,
        include_inf, policy=policy, constant=constant, detector_k=detector_k,
        detector_v=detector_v, policy_k=policy_k, constant_k=constant_k,
        policy_v=policy_v, constant_v=constant_v,
    )


def prefill_normalize(out_dtype, acc, l):
    """acc / max(l, 1e-30), cast — the epilogue outside the kernel."""
    B, C, H, Dh = acc.shape
    out = acc.reshape(B, C * H, Dh) / l.clamp_min(1e-30)[..., None]
    return out.to(out_dtype).reshape(B, C, H, Dh)


def _prefill_spec(q, k_pages, include_inf, fills):
    H = q.shape[2]
    if H % k_pages.shape[3]:
        raise ValueError(f"H={H} is not a multiple of Kh={k_pages.shape[3]}")
    return _operand_spec(q.dtype, include_inf, **fills)


def paged_prefill_plain(
    q, k_pages, v_pages, block_tables, q_start, layer, *,
    policy: str = "zero", constant: float = 0.0, include_inf: bool = True,
    detector_k=DEFAULT_DETECTOR, detector_v=DEFAULT_DETECTOR,
    policy_k: Optional[str] = None, constant_k: Optional[float] = None,
    policy_v: Optional[str] = None, constant_v: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the prefill kernel (any device)."""
    spec = _prefill_spec(q, k_pages, include_inf, dict(
        policy=policy, constant=constant, detector_k=detector_k,
        detector_v=detector_v, policy_k=policy_k, constant_k=constant_k,
        policy_v=policy_v, constant_v=constant_v,
    ))
    acc, m, l, slot_counts, counts = _prefill_plain(
        q, k_pages, v_pages, block_tables, q_start, int(layer), spec
    )
    return prefill_normalize(q.dtype, acc, l), slot_counts, counts


def paged_prefill_raw(
    q, k_pages, v_pages, block_tables, q_start, layer, *,
    policy: str = "zero", constant: float = 0.0, include_inf: bool = True,
    detector_k=DEFAULT_DETECTOR, detector_v=DEFAULT_DETECTOR,
    policy_k: Optional[str] = None, constant_k: Optional[float] = None,
    policy_v: Optional[str] = None, constant_v: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer of chunked-q paged prefill with fused on-read repair: chunk
    row ``c`` (context position ``q_start[b] + c``) attends to keys at
    positions ``<= q_start[b] + c``.  Rows past the caller's real chunk
    length are garbage the caller discards.  Returns ``(out (B, C, H, Dh),
    slot_counts (B, M), counts int32[8])``."""
    fills = dict(
        policy=policy, constant=constant, detector_k=detector_k,
        detector_v=detector_v, policy_k=policy_k, constant_k=constant_k,
        policy_v=policy_v, constant_v=constant_v,
    )
    if common.require_device(q, "paged prefill", k_pages, v_pages) == "cpu":
        return paged_prefill_plain(
            q, k_pages, v_pages, block_tables, q_start, layer,
            include_inf=include_inf, **fills,
        )
    if route(q, k_pages, v_pages) == "wgmma":
        return _prefill_wgmma(q, k_pages, v_pages, block_tables, q_start,
                              layer, include_inf, fills)
    spec = _prefill_spec(q, k_pages, include_inf, fills)
    acc, m, l, slot_counts, counts = _prefill_kernel(
        q, k_pages, v_pages, block_tables, q_start, layer, spec
    )
    return prefill_normalize(q.dtype, acc, l), slot_counts, counts
