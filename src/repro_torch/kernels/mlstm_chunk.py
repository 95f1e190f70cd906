"""Chunked mLSTM with stabilized exponential gating and reactive repair of
the q/k/v tiles.  Kernel: ``csrc/mlstm_chunk.cu``.

Per (b, h) the chunks run in order; within a chunk (after repairing its
q, k and v tiles), with F = cumsum(log_f) and b_j = log_i_j − F_j::

    m*     = max(m_prev, max_j b_j)
    W_tj   = (q_t·k_j)·exp(b_j − m*)                     (j ≤ t)
    y_t    = (W v + exp(m_prev − m*)·q_t C)_t
             / max(|Σ_j W_tj + exp(m_prev − m*)·q_t·n|, exp(−F_t − m*))
    C, n   ← exp(m_prev − m*)·(C, n) + Σ_j exp(b_j − m*)·k_j (v_jᵀ, 1)
    m      ← F_end + m*

with C, n, m starting at 0, 0, −1e30.  Products take f32 operands after
the repair and accumulate in f32; ``W v`` uses ``W`` in f32 (the oracle
``nn.xlstm._chunked_mlstm`` casts it to the value dtype first).

Repair uses the legacy detector: NaN, plus ±Inf with ``include_inf``.
``neighbor_mean`` fills a fatal lane with the mean of its operand's
(b, h, c) tile (Q, P), from a table per operand that ``kernels.tile_fill``
writes before the kernels run.
Counts (int32[8], slot 7 always 0) are per logical (b, h, c) tile, as the
reference kernel counts them::

    NAN_Q, INF_Q   fatal q lanes
    EV_Q           q tiles with a fatal lane
    NAN_KV, INF_KV fatal k plus v lanes
    EV_KV          chunks whose k or v tile had a fatal lane
    EV_TOTAL       chunks with any fatal lane

Routes on the card (:func:`route`, a pure function of the operands'
dtypes, shapes, contiguity and data pointers):

* ``"wgmma"``: q, k, v all bf16, contiguous, each 16-byte aligned, P a
  multiple of 8 up to ``WGMMA_MAX_P``, Q a multiple of 16 up to
  ``MAX_CHUNK``.  Tensor cores with f32 accumulation: S = q kᵀ (exact
  products); W v with W as three bf16 terms (exact) against v's finite
  lanes, the non-finite lanes' terms added in f32; q C with the f32 state C
  as a bf16 hi/lo pair; C ← resc C + kᵀ (src ∘ v) with src ∘ v as a hi/lo
  pair.  den is formed in f32 as the FFMA route forms it.  Each row of a
  chunk is formed scaled by a power of two that brings its terms to ~1
  (with strong forget gates they fall into f32's subnormal range, below
  any bf16 term); y is a ratio, so the scale cancels exactly.
  :func:`mlstm_chunk_split_plain` is the plain twin of this arithmetic.
* ``"ffma"``: everything else (f32, f16, other shapes and views), on the
  FP32 pipe, so exact f32 stays exact.

A failure on either route raises; neither falls back to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _native, common, tile_fill

NEG = -1e30

# counts layout (int32[8])
NAN_Q, INF_Q, EV_Q, NAN_KV, INF_KV, EV_KV, EV_TOTAL = range(7)

# the kernel's longest chunk (QMAX in csrc/mlstm_chunk.cu); a head dim P
# whose (P, 32) f32 slab of C overflows shared memory fails at launch on
# the FFMA route
MAX_CHUNK = 128
# the wgmma route's widest head (wg::MAX_BOXES * 64 in csrc/mlstm_chunk.cu:
# the (P, 32) slab of C lives in two warpgroups' registers)
WGMMA_MAX_P = 1024
# bf16 terms of the split operands on the wgmma route: W (three: exact for
# f32), C and src ∘ v (a hi/lo pair)
W_TERMS, STATE_TERMS = 3, 2


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"wgmma"`` or ``"ffma"``: which CUDA kernels take the call (the
    rule in the module docstring)."""
    if (q.dim() == 5 and k.shape == q.shape and v.shape == q.shape
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.numel() > 0
            and q.shape[4] % 8 == 0 and q.shape[4] <= WGMMA_MAX_P
            and q.shape[3] % 16 == 0 and q.shape[3] <= MAX_CHUNK
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                    for t in (q, k, v))):
        return "wgmma"
    return "ffma"


def split_bf16(x: torch.Tensor, terms: int = STATE_TERMS):
    """``terms`` tensors of bf16 values (held in f32) that sum to f32 ``x``:
    the first is bf16(x) rounded to nearest, each next one rounds what the
    earlier ones leave.  Where the first is ±Inf or NaN the rest are 0, so
    a non-finite lane is carried by the first alone.  Two terms keep ~16
    bits of x's significand (relative error ≤ 2⁻¹⁷), three all 24."""
    parts, rest = [], x.float()
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = torch.where(torch.isfinite(part), rest - part,
                           torch.zeros_like(rest))
    return parts


def _check_shapes(q, k, v, log_i, log_f):
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"mlstm_chunk needs q, k, v of one (B, H, nc, Q, P) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if log_i.shape != q.shape[:4] or log_f.shape != q.shape[:4]:
        raise ValueError(
            f"mlstm_chunk gates must be (B, H, nc, Q) = {tuple(q.shape[:4])}, "
            f"got {tuple(log_i.shape)}, {tuple(log_f.shape)}"
        )


def _repair_chunk(q, k, v, c, det, policy, constant):
    """Chunk ``c`` of q, k, v repaired and widened to f32, and its counts'
    increment (int64[7]), as the reference kernel counts a tile."""
    fixed, lanes = [], []
    for x in (q, k, v):
        t, nan_m, inf_m = common.repair_tile(
            x[:, :, c], common.detector_operand(det, x.dtype), policy, constant,
            x.shape[3:],
        )
        fixed.append(t.float())
        lanes.append((nan_m.sum(dim=(-2, -1)), inf_m.sum(dim=(-2, -1))))
    (nq, iq), (nk, ik), (nv, iv) = lanes              # each (B, H)
    ev_q = (nq + iq) > 0
    ev_kv = (nk + ik + nv + iv) > 0
    inc = torch.stack([
        nq.sum(), iq.sum(), ev_q.sum(), (nk + nv).sum(), (ik + iv).sum(),
        ev_kv.sum(), (ev_q | ev_kv).sum(),
    ])
    return fixed, inc


def mlstm_chunk_plain(
    q: torch.Tensor,         # (B, H, nc, Q, P)
    k: torch.Tensor,
    v: torch.Tensor,
    log_i: torch.Tensor,     # (B, H, nc, Q)
    log_f: torch.Tensor,
    *,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`mlstm_chunk_raw` (any device):
    the reference kernel's steps chunk by chunk, batched over (B, H)."""
    _check_shapes(q, k, v, log_i, log_f)
    B, H, nc, Q, P = q.shape
    det = common.resolve_detector(None, include_inf)
    dev = q.device
    counts = torch.zeros(8, dtype=torch.int64, device=dev)
    C = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, P), dtype=torch.float32, device=dev)
    m = torch.full((B, H), NEG, dtype=torch.float32, device=dev)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    ys = []
    for c in range(nc):
        (qf, kf, vf), inc = _repair_chunk(q, k, v, c, det, policy, constant)
        counts[:7] += inc

        li = log_i[:, :, c].float()                   # (B, H, Q)
        lf = log_f[:, :, c].float()
        F = torch.cumsum(lf, dim=-1)
        bsrc = li - F
        m_star = torch.maximum(m, bsrc.amax(dim=-1))  # (B, H)
        src = torch.exp(bsrc - m_star[..., None])     # (B, H, Q)
        resc = torch.exp(m - m_star)                  # (B, H)

        qk = torch.matmul(qf, kf.transpose(-1, -2))   # (B, H, Q, Q)
        W = torch.where(tril, qk * src[..., None, :], 0.0)
        num = torch.matmul(W, vf)
        den = W.sum(dim=-1)
        num = num + resc[..., None, None] * torch.matmul(qf, C)
        den = den + resc[..., None] * (qf * n[..., None, :]).sum(dim=-1)
        clamp = torch.exp(-F - m_star[..., None])
        ys.append(num / torch.maximum(den.abs(), clamp)[..., None])

        ks = kf * src[..., None]
        C = resc[..., None, None] * C + torch.matmul(ks.transpose(-1, -2), vf)
        n = resc[..., None] * n + ks.sum(dim=-2)
        m = F[..., -1] + m_star
    return torch.stack(ys, dim=2), counts.to(torch.int32)


def _nonfinite_terms(W: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Σ_j W_tj v_jn over v's non-finite lanes (B, H, Q, P), 0 elsewhere:
    the terms the wgmma route adds in f32 after W v_finite."""
    B, H, Q, P = v.shape
    out = torch.zeros((B, H, P, Q), dtype=torch.float32, device=v.device)
    b, h, j, n = (~torch.isfinite(v)).nonzero(as_tuple=True)
    out.index_put_((b, h, n), W[b, h, :, j] * v[b, h, j, n][:, None],
                   accumulate=True)
    return out.transpose(-1, -2)


def mlstm_chunk_split_plain(
    q: torch.Tensor,         # (B, H, nc, Q, P)
    k: torch.Tensor,
    v: torch.Tensor,
    log_i: torch.Tensor,     # (B, H, nc, Q)
    log_f: torch.Tensor,
    *,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the wgmma route's own arithmetic (any device).
    Row t of a chunk is formed scaled by a power of two s_t (its terms are
    at most exp(m_t − m*), m_t = max(m_prev, b_0..b_t)): W v as s_t W's
    three bf16 terms against v's finite lanes plus the non-finite lanes'
    terms in f32; s_t resc q C with q against C's hi/lo pair; den = Σ_j s_t
    W_tj + s_t resc q·n and the clamp times s_t, in f32; C updated by kᵀ
    against the hi/lo pair of src ∘ v.  Counts as
    :func:`mlstm_chunk_plain`'s."""
    _check_shapes(q, k, v, log_i, log_f)
    B, H, nc, Q, P = q.shape
    det = common.resolve_detector(None, include_inf)
    dev = q.device
    counts = torch.zeros(8, dtype=torch.int64, device=dev)
    C = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, P), dtype=torch.float32, device=dev)
    m = torch.full((B, H), NEG, dtype=torch.float32, device=dev)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    ys = []
    for c in range(nc):
        (qf, kf, vf), inc = _repair_chunk(q, k, v, c, det, policy, constant)
        counts[:7] += inc
        F = torch.cumsum(log_f[:, :, c].float(), dim=-1)
        bsrc = log_i[:, :, c].float() - F
        m_star = torch.maximum(m, bsrc.amax(dim=-1))
        src = torch.exp(bsrc - m_star[..., None])
        resc = torch.exp(m - m_star)

        # row t's power of two: its terms are all <= exp(m_t - m*), with m_t
        # its own stabilizer; they are scaled back to ~1 before any split
        m_row = torch.maximum(m[..., None], torch.cummax(bsrc, dim=-1).values)
        d = (m_star[..., None] - m_row) * 1.4426950408889634
        e = torch.where(d >= 126, 126.0, torch.where(d >= 1, d.floor(), 0.0))
        scale = torch.exp2(e)                         # (B, H, Q)
        sr = scale * resc[..., None]

        W = torch.where(tril, torch.matmul(qf, kf.transpose(-1, -2))
                        * src[..., None, :], 0.0) * scale[..., None]
        finite = torch.isfinite(vf)
        v_fin = torch.where(finite, vf, 0.0)
        num = sum(torch.matmul(w, v_fin) for w in split_bf16(W, W_TERMS))
        if not bool(finite.all()):
            num = num + _nonfinite_terms(W, vf)
        num = num + sr[..., None] * sum(torch.matmul(qf, part)
                                        for part in split_bf16(C, STATE_TERMS))
        den = W.sum(dim=-1) + sr * (qf * n[..., None, :]).sum(dim=-1)
        clamp = torch.exp(-F - m_star[..., None]) * scale
        ys.append(num / torch.maximum(den.abs(), clamp)[..., None])

        U = src[..., None] * vf
        C = resc[..., None, None] * C + sum(
            torch.matmul(kf.transpose(-1, -2), part)
            for part in split_bf16(U, STATE_TERMS))
        n = resc[..., None] * n + (kf * src[..., None]).sum(dim=-2)
        m = F[..., -1] + m_star
    return torch.stack(ys, dim=2), counts.to(torch.int32)


_SIGNATURE = [
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.I,
    _native.HOST_INTS, _native.U, _native.P, _native.P, _native.P, _native.P,
    _native.P, _native.P, _native.P,
]


_WGMMA_SIGNATURE = [
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.I,
    _native.I, _native.I, _native.I, _native.I, _native.HOST_INTS, _native.U,
    _native.P, _native.P, _native.P, _native.P, _native.P, _native.P,
    _native.P,
]


@functools.lru_cache(maxsize=None)
def _wgmma_scratch_bytes(B: int, H: int, nc: int, Q: int, P: int) -> int:
    """The wgmma route's scratch in bytes (csrc: wg::Scratch)."""
    out = ctypes.c_longlong(0)
    err = _native.function(
        "mlstm_chunk", "repro_mlstm_wgmma_scratch",
        [_native.I] * 5 + [ctypes.POINTER(ctypes.c_longlong)],
    )(B, H, nc, Q, P, ctypes.byref(out))
    _native.check(err, "mlstm_chunk scratch")
    return out.value


def _kernel(q, k, v, log_i, log_f, policy, constant, include_inf):
    dev = q.device
    for name, t in (("k", k), ("v", v), ("log_i", log_i), ("log_f", log_f)):
        if t.device != dev:
            raise ValueError(f"mlstm_chunk: {name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"mlstm_chunk kernel: {name} must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"mlstm_chunk kernel needs one dtype for q, k, v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in common.DTYPE_CODES:
        raise TypeError(f"mlstm_chunk kernel supports f32/bf16/f16, got {q.dtype}")
    B, H, nc, Q, P = q.shape
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"mlstm_chunk kernel takes chunks of 1..{MAX_CHUNK}, "
                         f"got Q = {Q}")
    # the reference kernel reads the gates as f32
    li = log_i.float().contiguous()
    lf = log_f.float().contiguous()
    y = torch.empty((B, H, nc, Q, P), dtype=torch.float32, device=dev)
    counts = torch.zeros(8, dtype=torch.int32, device=dev)
    consts = common.detector_operand(
        common.resolve_detector(None, include_inf), q.dtype
    )
    fill = common.fill_bits(policy, constant, q.dtype)
    tables = [tile_fill.table_or_none(policy, x, B * H * nc * Q, P, (Q, P),
                                      consts) for x in (q, k, v)]
    ptrs = [common.table_ptr(t) for t in tables]
    if route(q, k, v) == "wgmma":
        scratch = torch.empty(_wgmma_scratch_bytes(B, H, nc, Q, P),
                              dtype=torch.uint8, device=dev)
        err = _native.function(
            "mlstm_chunk", "repro_mlstm_chunk_wgmma", _WGMMA_SIGNATURE)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
            lf.data_ptr(), B, H, nc, Q, P, _native.int8_array(consts), fill,
            *ptrs, scratch.data_ptr(), y.data_ptr(), counts.data_ptr(),
            common.raw_stream(dev),
        )
    else:
        qk = torch.empty((B, H, nc, Q, Q), dtype=torch.float32, device=dev)
        err = _native.function("mlstm_chunk", "repro_mlstm_chunk", _SIGNATURE)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
            lf.data_ptr(), common.DTYPE_CODES[q.dtype], B, H, nc, Q, P,
            _native.int8_array(consts), fill, *ptrs, qk.data_ptr(), y.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _native.check(err, "mlstm_chunk")
    common.LAUNCHES["mlstm_chunk"] += 1
    return y, counts


def mlstm_chunk_raw(
    q: torch.Tensor,         # (B, H, nc, Q, P)
    k: torch.Tensor,
    v: torch.Tensor,
    log_i: torch.Tensor,     # (B, H, nc, Q)
    log_f: torch.Tensor,
    *,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked mLSTM.  Returns ``(y (B, H, nc, Q, P) f32, counts int32[8])``;
    the inputs are not modified."""
    if common.require_device(q, "mlstm_chunk", k, v, log_i, log_f) == "cpu":
        return mlstm_chunk_plain(
            q, k, v, log_i, log_f, policy=policy, constant=constant,
            include_inf=include_inf,
        )
    _check_shapes(q, k, v, log_i, log_f)
    return _kernel(q, k, v, log_i, log_f, policy, constant, include_inf)


def mlstm_chunked(
    q: torch.Tensor,         # (B, S, H, P) — the nn.xlstm layout
    k: torch.Tensor,
    v: torch.Tensor,
    log_i: torch.Tensor,     # (B, S, H)
    log_f: torch.Tensor,
    *,
    chunk: int = 128,
    policy: str = "zero",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layout adapter over :func:`mlstm_chunk_raw` for ``nn.xlstm``.
    Returns ``(y (B, S, H, P) f32, counts)``."""
    B, S, H, P = q.shape
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q

    def to5(x):
        return x.reshape(B, nc, Q, H, P).permute(0, 3, 1, 2, 4).contiguous()

    def gates(x):
        return x.reshape(B, nc, Q, H).permute(0, 3, 1, 2).contiguous()

    y, counts = mlstm_chunk_raw(
        to5(q), to5(k), to5(v), gates(log_i), gates(log_f), policy=policy,
    )
    return y.permute(0, 2, 3, 1, 4).reshape(B, S, H, P), counts
