"""Grouped-query attention with RoPE: full-sequence, dense-cache and paged
paths.

  forward       the whole sequence at once: ``direct`` materialises the
                (S, T) scores, ``chunked`` is the online-softmax form over
                (q_block, kv_block) tiles; ``impl="auto"`` takes chunked
                from 2,048 positions on, as the reference does
  decode        S new tokens per request against a dense (B, T, Kh, Dh)
                cache: the write at per-request ``pos``, then causal
                attention over the whole cache (``t <= pos + s``)
  paged_*       straight off the pool: the new K/V land in the pool's page
                slots in place, then the paged kernels attend and repair
                fatal K/V lanes on read

The full-sequence and dense-cache math is the reference's ``jnp`` math,
outside any kernel, kept as it is: f32 scores, softmax in f32, the weights
cast to V's dtype before P·V with f32 accumulation.  ``direct`` aligns its
causal mask bottom-right (``tril(k=T-S)``) and ``chunked`` top-left, as the
reference's two forms do.  Weights and the dense cache are read through the
use-site repair (``nn.layers.UseSites``); the cache read is pathless.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..kernels import paged_attention as paged_kernel
from . import initializers as ini
from .layers import UseSites, matmul_f32, param
from .rotary import apply_rope

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int, *,
                 qkv_bias: bool = False, rope_theta: float = 10000.0,
                 rotary_pct: float = 1.0, dtype=torch.bfloat16, device=None,
                 rcfg: Any = None, path: str = "", q_block: int = 512,
                 kv_block: int = 1024):
        super().__init__()
        if n_heads % n_kv:
            raise ValueError("GQA requires n_kv | n_heads")
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.qkv_bias, self.rope_theta, self.rotary_pct = (
            qkv_bias, rope_theta, rotary_pct,
        )
        self.dtype = dtype
        self.q_block, self.kv_block = q_block, kv_block
        H, K, Dh, D = n_heads, n_kv, head_dim, d_model
        self.wq = param((D, H * Dh), dtype, device)
        self.wk = param((D, K * Dh), dtype, device)
        self.wv = param((D, K * Dh), dtype, device)
        self.wo = param((H * Dh, D), dtype, device)
        self.inits = {n: ini.fan_in() for n in ("wq", "wk", "wv", "wo")}
        if qkv_bias:
            self.bq = param((H * Dh,), dtype, device)
            self.bk = param((K * Dh,), dtype, device)
            self.bv = param((K * Dh,), dtype, device)
            self.inits.update({n: ini.zeros for n in ("bq", "bk", "bv")})
        self.reads = UseSites(rcfg, path, tuple(self.inits))
        self.cache_reads = UseSites(rcfg, "", ("cache",))

    # ------------------------------------------------------------ helpers
    def _proj(self, x, w: str, b: str):
        read = self.reads.read
        y = matmul_f32(x, read(w, getattr(self, w)))
        if self.qkv_bias:
            y = y + read(b, getattr(self, b)).float()
        return y.to(self.dtype)

    def qkv(self, x: torch.Tensor):
        """(B, S, D) -> q (B, S, H, Dh), k/v (B, S, Kh, Dh)."""
        B, S, _ = x.shape
        q = self._proj(x, "wq", "bq")
        k = self._proj(x, "wk", "bk")
        v = self._proj(x, "wv", "bv")
        return (
            q.reshape(B, S, self.n_heads, self.head_dim),
            k.reshape(B, S, self.n_kv, self.head_dim),
            v.reshape(B, S, self.n_kv, self.head_dim),
        )

    def rope(self, q, k, positions):
        kw = dict(theta=self.rope_theta, rotary_pct=self.rotary_pct)
        return apply_rope(q, positions, **kw), apply_rope(k, positions, **kw)

    def out(self, ctx: torch.Tensor) -> torch.Tensor:
        B, S = ctx.shape[:2]
        ctx = ctx.reshape(B, S, self.n_heads * self.head_dim)
        return torch.matmul(ctx, self.reads.read("wo", self.wo)).to(self.dtype)

    # ------------------------------------------------------ full sequence
    def forward(self, x: torch.Tensor, positions=None,
                impl: str = "auto") -> torch.Tensor:
        """Causal self-attention over ``x`` (B, S, D) -> (B, S, D)."""
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        q, k, v = self.qkv(x)
        q, k = self.rope(q, k, positions)
        if impl == "auto":
            impl = "chunked" if S >= 2048 else "direct"
        if impl == "chunked":
            ctx = chunked_attention(q, k, v, causal=True, q_block=self.q_block,
                                    kv_block=self.kv_block)
        else:
            ctx = direct_attention(q, k, v, causal=True)
        return self.out(ctx)

    # --------------------------------------------------------- dense cache
    def cache_defs(self, batch: int, max_seq: int
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """The dense KV cache, ``(batch, max_seq, Kh, Dh)`` per leaf."""
        shape = (batch, max_seq, self.n_kv, self.head_dim)
        return {"k": (shape, self.dtype), "v": (shape, self.dtype)}

    def decode(self, x, cache_k, cache_v, pos):
        """S new tokens per request (S == 1: decode; S > 1: a batched
        prefill) against this layer's dense cache ``(B, T, Kh, Dh)``,
        updated in place.  ``pos`` is the write position, a scalar or one
        per request; query s attends to cache positions ``t <= pos + s``.
        The cache is read through the use-site repair first, and what the
        read repaired is written back with the new K/V, as the reference
        returns its repaired cache.  Returns ``(B, S, D)``."""
        B, S = x.shape[:2]
        dev = x.device
        q, k_new, v_new = self.qkv(x)
        start = torch.as_tensor(pos, device=dev).to(torch.int64).reshape(-1)
        start = start.expand(B)
        pos_arr = start[:, None] + torch.arange(S, device=dev)[None, :]
        q, k_new = self.rope(q, k_new, pos_arr)
        ck = self.cache_reads.read("cache", cache_k)
        cv = self.cache_reads.read("cache", cache_v)
        T = ck.shape[1]
        # dynamic_update_slice semantics: the write window is clamped inside
        cols = start.clamp(0, T - S)[:, None] + torch.arange(S, device=dev)
        rows = torch.arange(B, device=dev)[:, None]
        ck[rows, cols] = k_new.to(ck.dtype)
        cv[rows, cols] = v_new.to(cv.dtype)
        if ck is not cache_k:
            cache_k.copy_(ck)
        if cv is not cache_v:
            cache_v.copy_(cv)
        K, G, Dh = self.n_kv, self.n_heads // self.n_kv, self.head_dim
        qg = q.reshape(B, S, K, G, Dh)
        scores = torch.einsum(
            "bqkgd,btkd->bkgqt", qg.float(), ck.float()
        ) / math.sqrt(Dh)
        t = torch.arange(T, device=dev)
        valid = t[None, None, None, None, :] <= pos_arr[:, None, None, :, None]
        scores = torch.where(valid, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        ctx = torch.einsum(
            "bkgqt,btkd->bqkgd", w.to(cv.dtype).float(), cv.float()
        ).to(self.dtype)
        return self.out(ctx.reshape(B, S, self.n_heads, Dh))

    def paged_cache_defs(
        self, n_pages: int, page_size: int, n_layers: int = 1
    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Pool leaves ``(n_pages, n_layers, page_size, Kh, Dh)``, page axis
        leading: one page is one contiguous row."""
        shape = (n_pages, n_layers, page_size, self.n_kv, self.head_dim)
        return {"k": (shape, self.dtype), "v": (shape, self.dtype)}

    # -------------------------------------------------------- paged paths
    def paged_decode(
        self, x, k_pages, v_pages, block_tables, positions, layer: int, *,
        detector_k=None, detector_v=None, policy_k="zero", constant_k=0.0,
        policy_v="zero", constant_v=0.0, split_k: int = 1,
    ):
        """One decode token per request straight off the pool: the new K/V
        land in one page slot per request (``[page, layer, offset]``, in
        place), then the paged decode kernel.  Returns ``(out (B, 1, D),
        slot_counts (B, M), counts int32[8])``."""
        B, S = x.shape[:2]
        if S != 1:
            raise ValueError("paged_decode consumes exactly one token per request")
        q, k_new, v_new = self.qkv(x)
        pos = positions.reshape(B).to(torch.int32)
        q, k_new = self.rope(q, k_new, pos[:, None])
        pg = k_pages.shape[2]
        slot = torch.arange(B, device=x.device)
        page = block_tables[slot, (pos // pg).long()].long()
        off = (pos % pg).long()
        k_pages[page, layer, off] = k_new[:, 0].to(k_pages.dtype)
        v_pages[page, layer, off] = v_new[:, 0].to(v_pages.dtype)
        kw = dict(
            detector_k=detector_k, detector_v=detector_v,
            policy_k=policy_k, constant_k=constant_k,
            policy_v=policy_v, constant_v=constant_v,
        )
        q0 = q[:, 0].contiguous()
        if split_k > 1:
            ctx, slot_counts, counts = paged_kernel.paged_attention_splitk_raw(
                q0, k_pages, v_pages, block_tables, pos, layer,
                splits=split_k, **kw,
            )
        else:
            ctx, slot_counts, counts = paged_kernel.paged_attention_raw(
                q0, k_pages, v_pages, block_tables, pos, layer, **kw,
            )
        return self.out(ctx[:, None]), slot_counts, counts

    def paged_prefill(
        self, x, k_pages, v_pages, block_tables, q_start, q_len, layer: int, *,
        detector_k=None, detector_v=None, policy_k="zero", constant_k=0.0,
        policy_v="zero", constant_v=0.0,
    ):
        """One causal chunk straight off the pool.  Padded chunk rows
        (``row >= q_len``) must not write: a zero write would heal a flip
        parked in an unwritten lane.  They re-write the request's last
        valid position with its own value instead.  Returns ``(out
        (B, C, D), slot_counts (B, M), counts int32[8])``; rows past
        ``q_len`` are garbage the caller discards."""
        B, C = x.shape[:2]
        q, k_new, v_new = self.qkv(x)
        dev = x.device
        qs = q_start.reshape(B).to(torch.int32)
        ql = q_len.reshape(B).to(torch.int32)
        pos_arr = qs[:, None] + torch.arange(C, dtype=torch.int32, device=dev)
        q, k_new = self.rope(q, k_new, pos_arr)
        pg = k_pages.shape[2]
        valid = torch.arange(C, device=dev)[None, :] < ql[:, None]     # (B, C)
        last = (ql - 1).clamp_min(0).long()                             # (B,)
        safe_pos = torch.where(valid, pos_arr, (qs + last)[:, None]).long()
        bslot = torch.arange(B, device=dev)[:, None].expand(B, C)
        page = block_tables[bslot, safe_pos // pg].long()
        off = safe_pos % pg

        def dedup(new):                                   # (B, C, Kh, Dh)
            idx = last[:, None, None, None].expand(B, 1, *new.shape[2:])
            lastv = new.gather(1, idx)
            return torch.where(valid[..., None, None], new, lastv)

        k_pages[page, layer, off] = dedup(k_new).to(k_pages.dtype)
        v_pages[page, layer, off] = dedup(v_new).to(v_pages.dtype)
        ctx, slot_counts, counts = paged_kernel.paged_prefill_raw(
            q.contiguous(), k_pages, v_pages, block_tables, qs, layer,
            detector_k=detector_k, detector_v=detector_v,
            policy_k=policy_k, constant_k=constant_k,
            policy_v=policy_v, constant_v=constant_v,
        )
        return self.out(ctx), slot_counts, counts


# --------------------------------------------------------------------------
# Full-sequence attention math (the reference's jnp forms).
# --------------------------------------------------------------------------


def _gqa_scores(q, k):
    """(B, S, H, Dh) x (B, T, Kh, Dh) -> (B, Kh, G, S, T) f32 scaled scores."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, Dh)
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / math.sqrt(Dh)


def direct_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """Materialised scores; the causal mask aligned bottom-right."""
    B, S, H, Dh = q.shape
    T = k.shape[1]
    scores = _gqa_scores(q, k)
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device).tril(T - S)
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype).float(), v.float())
    return ctx.reshape(B, S, H, Dh).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, q_block: int,
                      kv_block: int) -> torch.Tensor:
    """Online-softmax attention over (q_block, kv_block) tiles; the causal
    mask aligned top-left (``q >= k`` from position 0 on both sides)."""
    B, S, H, Dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qb, kb = min(q_block, S), min(kv_block, T)
    if S % qb or T % kb:
        raise ValueError(f"blocks ({qb}, {kb}) must divide (S, T) = ({S}, {T})")
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device
    ks = k.reshape(B, T // kb, kb, K, Dh).permute(1, 0, 3, 2, 4).float()
    vs = v.reshape(B, T // kb, kb, K, Dh).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(S // qb):
        q_blk = q[:, qi * qb:(qi + 1) * qb].reshape(B, qb, K, G, Dh)
        q_blk = q_blk.permute(0, 2, 3, 1, 4).float()         # (B, K, G, qb, Dh)
        acc = torch.zeros(B, K, G, qb, Dh, dtype=torch.float32, device=dev)
        m = torch.full((B, K, G, qb), NEG_INF, dtype=torch.float32, device=dev)
        denom = torch.zeros(B, K, G, qb, dtype=torch.float32, device=dev)
        qpos = qi * qb + torch.arange(qb, device=dev)
        for kj in range(T // kb):
            s = torch.einsum("bkgqd,bktd->bkgqt", q_blk, ks[kj]) * scale
            if causal:
                kpos = kj * kb + torch.arange(kb, device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            denom = denom * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,bktd->bkgqd", p.to(v.dtype).float(),
                              vs[kj].float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append(acc / denom.clamp_min(1e-30)[..., None])
    out = torch.stack(outs)                        # (nq, B, K, G, qb, Dh)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, Dh).to(q.dtype)
