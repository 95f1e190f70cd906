"""Grouped-query attention with RoPE over the paged KV pool.

Only the paged paths are ported (``paged_decode``, ``paged_prefill``): the
new K/V are written into the pool's page slots in place, then the paged
kernels attend straight off the pool, repairing fatal K/V lanes on read.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..kernels import paged_attention as paged_kernel
from . import initializers as ini
from .layers import param
from .rotary import apply_rope


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int, *,
                 qkv_bias: bool = False, rope_theta: float = 10000.0,
                 rotary_pct: float = 1.0, dtype=torch.bfloat16, device=None):
        super().__init__()
        if n_heads % n_kv:
            raise ValueError("GQA requires n_kv | n_heads")
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.qkv_bias, self.rope_theta, self.rotary_pct = (
            qkv_bias, rope_theta, rotary_pct,
        )
        self.dtype = dtype
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

    # ------------------------------------------------------------ helpers
    def _proj(self, x, w, b):
        y = torch.matmul(x, w)
        if b is not None:
            y = y.float() + b.float()
        return y.to(self.dtype)

    def qkv(self, x: torch.Tensor):
        """(B, S, D) -> q (B, S, H, Dh), k/v (B, S, Kh, Dh)."""
        B, S, _ = x.shape
        bias = self.qkv_bias
        q = self._proj(x, self.wq, self.bq if bias else None)
        k = self._proj(x, self.wk, self.bk if bias else None)
        v = self._proj(x, self.wv, self.bv if bias else None)
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
        return torch.matmul(ctx, self.wo).to(self.dtype)

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
