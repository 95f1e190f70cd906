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
  ``"heads"``  the same operands where one slot's tiles exceed a block
               (StableLM-1.6B's f32 pool: 2 x 128 KiB) but one KV head's
               share of them fits (:func:`heads_smem`).  One native call:
               the scan's memset, the scan kernel (the counts and one K and
               one V flag a slot, as the prefill's), then one block per
               (request, KV head) over that head's rows of every slot, the
               flagged ones repaired, with the fused route's walk, warps
               and merge; its slots are split over a cluster too until a
               request has as many blocks as the card has SMs
               (:func:`heads_partition`; plain twin
               :func:`paged_decode_heads_plain`).
  ``"walk"``   everything else (the tests' small head dims; offset views;
               mixed dtypes): one block per (request, split) walks its
               slots one after another, each page in groups of KV heads
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
               offset views), head dims up to 512: the same scan, then
               FFMA_ROWS of one KV head's rows a block over its live
               slots' rows of that head, repaired where flagged, on the
               FP32 pipe with register tiles, the online softmax page by
               page as the reference's, the normalised output written
               (:func:`ffma_smem`, :func:`ffma_round`).

A failure on any route raises; none falls back to another.  The walk
decode stages a page as f32 in groups of KV heads, the largest group that
fits a block's shared memory, and the FFMA prefill stages rounds of one KV
head's rows, so only a pool where not even one KV head's page fits a block
is refused before any launch (:func:`smem_refusal`, :func:`pool_refusal`),
and an FFMA prefill at a head dim over 512.
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
# the heads decode route splits a request's slots over a cluster too where
# its KV heads give fewer blocks than the H100's 132 SMs
HEADS_MIN_BLOCKS = 132
# the FFMA prefill (csrc/paged_prefill.cu, namespace pf): q rows a block,
# pages a round, the largest head dim (its register tile)
FFMA_ROWS = 32
FFMA_MAX_ROUND = 32
FFMA_MAX_HEAD_DIM = 512
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


def heads_smem(H: int, Dh: int, pg: int, Kh: int, itemsize: int) -> int:
    """Dynamic shared-memory bytes of a heads decode block that stages one
    slot: the fused layout (:func:`fused_smem`) for the block's G = H / Kh
    query heads over one KV head's rows of the slot (csrc: ``fd::Layout``
    with one KV head)."""
    return fused_smem(H // Kh, Dh, pg, 1, itemsize)


def decode_route(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor) -> str:
    """``"fused"``, ``"heads"`` or ``"walk"``: which CUDA kernels take a
    decode call (the rule in the module docstring)."""
    ops = (q, k_pages, v_pages)
    if (q.dtype == k_pages.dtype == v_pages.dtype and q.dtype in _FUSED_DTYPES
            and q.dim() == 3 and k_pages.dim() == 5
            and k_pages.shape == v_pages.shape
            and q.shape[-1] == k_pages.shape[-1] in _FUSED_HEAD_DIMS
            and q.shape[1] % k_pages.shape[3] == 0
            and all(t.numel() > 0 for t in ops)
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ops)):
        H, Dh = q.shape[1:]
        pg, Kh = k_pages.shape[2:4]
        if fused_smem(H, Dh, pg, Kh, q.element_size()) <= BLOCK_SMEM:
            return "fused"
        if heads_smem(H, Dh, pg, Kh, q.element_size()) <= BLOCK_SMEM:
            return "heads"
    return "walk"


def heads_partition(M: int, Kh: int) -> Tuple[int, int]:
    """``(nb, spb)``: the heads decode route's blocks per (request, KV
    head) and slots per block.  A request's Kh KV heads each walk its M
    slots; a warp walks a block's slots one after another, so they are
    split, as the fused route's are, into spb = ceil(M / s) consecutive
    slots a block for s = min(M, 8, ceil(HEADS_MIN_BLOCKS / Kh)) groups (one
    cluster of nb = ceil(M / spb) blocks a KV head, about the card's SMs a
    request where M allows)."""
    split = min(M, FUSED_MAX_CLUSTER, -(-HEADS_MIN_BLOCKS // Kh))
    spb = -(-M // split)
    return -(-M // spb), spb


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


def walk_group(H: int, Dh: int, pg: int, Kh: int) -> int:
    """KV heads a walk decode block stages at a time: the most, up to
    ``Kh``, whose :func:`walk_smem` fits BLOCK_SMEM; 0 when not even one
    KV head's page fits.  The wrapper passes it and its bytes to the
    kernel's launch."""
    return next((kg for kg in range(Kh, 0, -1)
                 if walk_smem(H, Dh, pg, Kh, kg) <= BLOCK_SMEM), 0)


def ffma_smem(Dh: int, pg: int, itemsize: int, rnd: int) -> int:
    """Dynamic shared-memory bytes of an FFMA prefill block that stages
    ``rnd`` pages of one KV head at a time: its FFMA_ROWS q rows as f32 (Dh
    rounded up to 4 lanes), per page its id and flags and each row's
    rescale, each row's l, the rows' scores (FFMA_ROWS, rnd·pg + 4), and
    the pages' K rows (padded by 16 bytes) and V rows in the storage dtype,
    each 16-byte aligned (csrc/paged_prefill.cu: ``pf::Layout``)."""
    r, dpad = FFMA_ROWS, -(-Dh // 4) * 4
    row = -(-dpad * itemsize // 16) * 16
    return (4 * r * dpad + 16 * rnd + 4 * r * rnd + 4 * r
            + 4 * r * (rnd * pg + 4) + rnd * pg * (2 * row + 16))


def ffma_round(Dh: int, pg: int, itemsize: int, M: int) -> int:
    """Pages an FFMA prefill block stages at a time: the most, up to
    FFMA_MAX_ROUND and the block table's M, whose :func:`ffma_smem` fits
    BLOCK_SMEM; 0 when not even one page of one KV head fits.  The wrapper
    passes it and its bytes to the kernel's launch."""
    return next((n for n in range(min(M, FFMA_MAX_ROUND), 0, -1)
                 if ffma_smem(Dh, pg, itemsize, n) <= BLOCK_SMEM), 0)


def smem_refusal(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor) -> Optional[str]:
    """Why the card cannot take this call: the route :func:`decode_route`
    (a 3-D q) or :func:`route` (a 4-D q) picks stages a page in groups of
    KV heads or in rounds of one KV head's rows, and not even one KV head's
    page fits BLOCK_SMEM (or the FFMA prefill's head dim is over
    FFMA_MAX_HEAD_DIM); ``None`` where it does."""
    H, Dh = q.shape[-2:]
    pg, Kh = k_pages.shape[2:4]
    dt = str(q.dtype).split('.')[-1]
    if q.dim() == 3:
        if (decode_route(q, k_pages, v_pages) != "walk"
                or walk_group(H, Dh, pg, Kh)):
            return None
        what, need = "paged decode (walk route)", walk_smem(H, Dh, pg, Kh, 1)
    else:
        if route(q, k_pages, v_pages) == "wgmma":
            return None
        if ffma_round(Dh, pg, k_pages.element_size(), 1):
            if Dh <= FFMA_MAX_HEAD_DIM:
                return None
            return (f"paged prefill (ffma route) takes head dims up to "
                    f"{FFMA_MAX_HEAD_DIM}, not {Dh} ({dt})")
        what = "paged prefill (ffma route)"
        need = ffma_smem(Dh, pg, k_pages.element_size(), 1)
    return (f"{what} needs {need} B of shared memory a block for one KV "
            f"head's page, over the {BLOCK_SMEM} B a block has, at {H} heads "
            f"of {Dh} on pages of {pg} x {Kh} KV heads in {dt}")


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
               flags: Optional[torch.Tensor] = None,
               rows: int = WGMMA_ROWS) -> torch.Tensor:
    """How many leading block-table slots each row block of ``rows`` rows
    (the wgmma route's WGMMA_ROWS, the FFMA route's FFMA_ROWS) loads, (B,
    ceil(C·G / rows)) int64: slot j is live for a block iff ``j·pg <=
    q_start[b] + c``, c the chunk row of the block's last row.  The other slots' keys are masked for every row of the
    block.  With the scan's ``flags`` (:func:`prefill_scan_plain`), a block
    also loads every slot up to its request's last one whose V stays
    non-finite after the repair (bit 1 of the V flag): its 0 × NaN reaches
    the masked rows, as in the reference (csrc: ``key_end``)."""
    n = -(-C * G // rows)
    last = torch.clamp((torch.arange(n) + 1) * rows, max=C * G) - 1
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
    """The plain version of the scan kernel (csrc/paged.cuh ``page_scan``,
    which the wgmma and FFMA prefill and the heads decode launch first):
    every (b, j) slot's K and V tiles at ``layer`` classified, null-padded
    slots and slots past every row's causal limit included.  Returns ``(slot_counts
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
def _sig(n_in: int, n_int: int, n_out: int) -> list:
    """ctypes argument types of a paged entry point: ``n_in`` pointers, then
    ``n_int`` ints, the two detectors' host int32[8] and the two fills'
    bits, then ``n_out`` pointers (the last the stream)."""
    return ([_native.P] * n_in + [_native.I] * n_int + [_native.HOST_INTS] * 2
            + [_native.U] * 2 + [_native.P] * n_out)


_DECODE_SIG = _sig(5, 12, 9)
_DECODE_FUSED_SIG = _sig(5, 10, 6)
_DECODE_HEADS_SIG = _sig(5, 12, 7)
_PREFILL_SIG = _sig(5, 13, 7)
_PREFILL_WGMMA_SIG = _sig(5, 11, 7)
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


def _pool_call(what, vec_name, q, k_pages, v_pages, bt, vec, layer,
               include_inf, fills):
    """What every one-native-call route checks and passes: ``(P, L, pg, Kh,
    M, layer, tail, tables)``, ``tail`` the detectors' host ints and the
    fills' bits, ``tables`` the ``neighbor_mean`` tables (or None), which
    the caller holds until its launch."""
    _check_tables(q, bt, vec, what, vec_name)
    (P, L, pg, Kh, Dk), tail, nm_spec = _pool_constants(
        what, k_pages.shape, v_pages.shape, q.dtype, include_inf, **fills)
    B, H, Dh = q.shape[0], q.shape[-2], q.shape[-1]
    if (Dk != Dh or H % Kh or bt.dim() != 2 or bt.shape[0] != B
            or bt.shape[1] < 1 or vec.shape != (B,)):
        raise ValueError(f"{what}: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, block tables "
                         f"{tuple(bt.shape)} and {vec_name} "
                         f"{tuple(vec.shape)} do not fit")
    layer = int(layer)
    if not 0 <= layer < L:
        raise IndexError(f"{what}: layer {layer} of a {L}-layer pool")
    tables = ((None, None) if nm_spec is None
              else _pool_tables(k_pages, v_pages, layer, nm_spec))
    return P, L, pg, Kh, bt.shape[1], layer, tail, tables


def _scan_buffer(B, M, device):
    """One int32 buffer for a route that runs the scan: counts (8), the
    per-request poison ends (B), slot_counts (B, M) and flags (B, M, 2);
    returns it and the device addresses of slot_counts and flags."""
    head = 8 + B
    buf = torch.empty(head + 3 * B * M, dtype=torch.int32, device=device)
    base = buf.data_ptr()
    return buf, base + 4 * head, base + 4 * (head + B * M)


def _prefill_native(q, k_pages, v_pages, bt, q_start, layer, include_inf,
                    fills, prefill_route):
    """The wgmma or the FFMA prefill route: one native call zeroes the
    counts and launches the scan and the main kernel, which writes the
    normalised output."""
    what = "paged prefill"
    if prefill_route == "ffma":
        _check_operands(q, k_pages, v_pages, bt, q_start, what)
        _check_smem(q, k_pages, v_pages)
    P, L, pg, Kh, M, layer, tail, tables = _pool_call(
        what, "q_start", q, k_pages, v_pages, bt, q_start, layer, include_inf,
        fills)
    B, C, H, Dh = q.shape
    buf, slots, flags = _scan_buffer(B, M, q.device)
    out = torch.empty_like(q)
    ints = [common.DTYPE_CODES[q.dtype], B, C, H, Dh, P, L, pg, Kh, M, layer]
    if prefill_route == "wgmma":
        fn = _native.function("paged_prefill", "repro_paged_prefill_wgmma",
                              _PREFILL_WGMMA_SIG)
    else:
        rnd = ffma_round(Dh, pg, k_pages.element_size(), M)
        ints += [rnd, ffma_smem(Dh, pg, k_pages.element_size(), rnd)]
        fn = _native.function("paged_prefill", "repro_paged_prefill",
                              _PREFILL_SIG)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             bt.data_ptr(), q_start.data_ptr(), *ints, *tail,
             *map(common.table_ptr, tables),
             out.data_ptr(), slots, flags, buf.data_ptr(),
             common.raw_stream(q.device))
    _native.check(err, f"paged prefill ({prefill_route})")
    common.LAUNCHES["paged_prefill"] += 1
    return out, _slots_view(buf, B, M), buf[:8]


def _slots_view(buf, B, M):
    """slot_counts (B, M) in a :func:`_scan_buffer`."""
    head = 8 + B
    return buf[head:head + B * M].view(B, M)


def _decode_native(q, k_pages, v_pages, bt, pos, layer, include_inf, fills,
                   decode_route):
    """The fused or the heads decode route: one native call zeroes the
    counts and launches ``decode_fused``, or the scan and
    ``decode_heads``."""
    P, L, pg, Kh, M, layer, tail, tables = _pool_call(
        "paged decode", "positions", q, k_pages, v_pages, bt, pos, layer,
        include_inf, fills)
    B, H, Dh = q.shape
    out = torch.empty_like(q)
    ints = [common.DTYPE_CODES[q.dtype], B, H, Dh, P, L, pg, Kh, M, layer]
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            bt.data_ptr(), pos.data_ptr()]
    if decode_route == "fused":
        buf = torch.empty(8 + B * M, dtype=torch.int32, device=q.device)
        err = _native.function("paged_decode", "repro_paged_decode_fused",
                               _DECODE_FUSED_SIG)(
            *ptrs, *ints, *tail, *map(common.table_ptr, tables),
            out.data_ptr(), buf.data_ptr() + 32,
            buf.data_ptr(), common.raw_stream(q.device))
        slot_counts = buf[8:].view(B, M)
    else:
        buf, slots, flags = _scan_buffer(B, M, q.device)
        err = _native.function("paged_decode", "repro_paged_decode_heads",
                               _DECODE_HEADS_SIG)(
            *ptrs, *ints, *heads_partition(M, Kh), *tail,
            *map(common.table_ptr, tables),
            out.data_ptr(), slots, flags, buf.data_ptr(),
            common.raw_stream(q.device))
        slot_counts = _slots_view(buf, B, M)
    _native.check(err, f"paged decode ({decode_route})")
    common.LAUNCHES["paged_decode"] += 1
    return out, slot_counts, buf[:8]


def _scan_kernel(k_pages, v_pages, block_tables, layer, *, include_inf=True,
                 detector_k=DEFAULT_DETECTOR, detector_v=DEFAULT_DETECTOR,
                 policy_v="zero", constant_v=0.0):
    """The scan kernel alone (csrc/paged.cuh ``page_scan``, any dtype and
    view), the twin of :func:`prefill_scan_plain` (which the wgmma and FFMA
    prefill and the heads decode launch themselves): ``(slot_counts,
    counts, flags, poison_end)``, ``poison_end`` (B,) the end of each
    request's last slot with bit 1 of its V flag."""
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


def _own_partition_plain(q, k_pages, v_pages, block_tables, positions, layer,
                         spb, include_inf, fills):
    spec = _decode_spec(q, k_pages, block_tables, 1, include_inf, fills)
    return _decode_plain(q, k_pages, v_pages, block_tables, positions,
                         int(layer), spb, spec)


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
    return _own_partition_plain(
        q, k_pages, v_pages, block_tables, positions, layer,
        fused_partition(block_tables.shape[1])[1], include_inf, dict(
            policy=policy, constant=constant, detector_k=detector_k,
            detector_v=detector_v, policy_k=policy_k, constant_k=constant_k,
            policy_v=policy_v, constant_v=constant_v))


def paged_decode_heads_plain(
    q, k_pages, v_pages, block_tables, positions, layer, *,
    policy: str = "zero", constant: float = 0.0, include_inf: bool = True,
    detector_k=DEFAULT_DETECTOR, detector_v=DEFAULT_DETECTOR,
    policy_k: Optional[str] = None, constant_k: Optional[float] = None,
    policy_v: Optional[str] = None, constant_v: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain twin of the heads decode route's partition
    (:func:`heads_partition`): the page walk in groups of ``spb``
    consecutive slots (every KV head walks the same groups, so one walk
    serves them all)."""
    return _own_partition_plain(
        q, k_pages, v_pages, block_tables, positions, layer,
        heads_partition(block_tables.shape[1], k_pages.shape[3])[1],
        include_inf, dict(
            policy=policy, constant=constant, detector_k=detector_k,
            detector_v=detector_v, policy_k=policy_k, constant_k=constant_k,
            policy_v=policy_v, constant_v=constant_v))


def _decode(q, k_pages, v_pages, block_tables, positions, layer, splits,
            include_inf, **fills):
    if common.require_device(q, "paged decode", k_pages, v_pages) == "cpu":
        return paged_decode_plain(
            q, k_pages, v_pages, block_tables, positions, layer,
            splits=splits, include_inf=include_inf, **fills,
        )
    kernel_route = decode_route(q, k_pages, v_pages)
    if kernel_route != "walk":
        _check_splits(block_tables, splits)
        return _decode_native(q, k_pages, v_pages, block_tables, positions,
                              layer, include_inf, fills, kernel_route)
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
    return _prefill_native(q, k_pages, v_pages, block_tables, q_start, layer,
                           include_inf, fills, route(q, k_pages, v_pages))
