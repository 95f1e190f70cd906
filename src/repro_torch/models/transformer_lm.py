"""Decoder-only transformer LM (the dense Qwen2 family) over the paged pool.

A Python loop over per-layer blocks replaces the reference's ``lax.scan``;
the layer index reaches the kernels as an argument, so one kernel serves
every layer.  Ported surface: embedding, ``serve_step_paged`` (one decode
token per request), ``prefill_paged`` (one causal prompt chunk), final norm
and the tied readout.  Other families (LayerNorm, GeLU, MoE, untied heads)
are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import device as device_lib
from ..configs.base import ArchConfig
from ..nn import initializers as ini
from ..nn.attention import Attention
from ..nn.layers import Embedding, RMSNorm
from ..nn.mlp import SwiGLU


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dt = cfg.dtype
        self.norm1 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.attn = Attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta,
            rotary_pct=cfg.rotary_pct, dtype=dt, device=device,
        )
        self.norm2 = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype=dt, device=device)


class TransformerLM(nn.Module):
    supports_paged_kv = True
    supports_paged_decode = True
    supports_paged_prefill = True

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0):
        super().__init__()
        unported = []
        if cfg.norm != "rms":
            unported.append(f"norm={cfg.norm!r}")
        if cfg.mlp != "swiglu":
            unported.append(f"mlp={cfg.mlp!r}")
        if cfg.n_experts:
            unported.append("MoE")
        if not cfg.tie_embeddings:
            unported.append("untied lm_head")
        if unported:
            raise NotImplementedError(
                f"{', '.join(unported)} not ported: ROADMAP slice 5 "
                "(the other families)"
            )
        dev = device_lib.resolve(device)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype=cfg.dtype, device=dev)
        self.layers = nn.ModuleList(Block(cfg, dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=dev)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def init_weights(self, seed: int) -> None:
        """Random weights under the reference's init scheme, drawn in module
        order from one generator seeded with ``seed`` on the weights'
        device."""
        ini.init_weights(self, seed, self.device)

    def paged_cache_defs(self, n_pages: int, page_size: int):
        """``{"layers/k": (shape, dtype), "layers/v": ...}``."""
        defs = self.layers[0].attn.paged_cache_defs(
            n_pages, page_size, self.cfg.n_layers
        )
        return {f"layers/{name}": d for name, d in defs.items()}

    def _walk(self, h, attend):
        """Run the layers; ``attend(attn, x, layer)`` is the paged attention
        call.  Returns (final hidden, slot_counts, counts) summed over
        layers."""
        slot_acc = counts_acc = None
        for i, blk in enumerate(self.layers):
            a, slot, cnt = attend(blk.attn, blk.norm1(h), i)
            h = h + a
            h = h + blk.mlp(blk.norm2(h))
            slot_acc = slot if slot_acc is None else slot_acc + slot
            counts_acc = cnt if counts_acc is None else counts_acc + cnt
        return self.final_norm(h), slot_acc, counts_acc

    @staticmethod
    def _fill_kw(detectors, fills, policy, constant):
        detectors = detectors or {}
        fills = fills or {}
        fk = fills.get("k", (policy, constant))
        fv = fills.get("v", (policy, constant))
        return dict(
            detector_k=detectors.get("k"), detector_v=detectors.get("v"),
            policy_k=fk[0], constant_k=fk[1], policy_v=fv[0], constant_v=fv[1],
        )

    @torch.no_grad()
    def serve_step_paged(
        self,
        pool: Dict[str, torch.Tensor],   # {"layers/k", "layers/v"}: (P, L, pg, Kh, Dh)
        tokens: torch.Tensor,            # (B, 1)
        block_tables: torch.Tensor,      # (B, M) int32
        positions: torch.Tensor,         # (B,) int32 write position
        *,
        detectors: Optional[Dict] = None,
        policy: str = "zero",
        constant: float = 0.0,
        fills: Optional[Dict] = None,
        split_k: int = 1,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One decode step straight off the pool (updated in place).
        Returns ``(logits (B, 1, V) f32, slot_counts (B, M), counts)``."""
        kw = self._fill_kw(detectors, fills, policy, constant)
        kp, vp = pool["layers/k"], pool["layers/v"]

        def attend(attn, x, layer):
            return attn.paged_decode(
                x, kp, vp, block_tables, positions, layer, split_k=split_k, **kw
            )

        h, slot_counts, counts = self._walk(self.embed(tokens), attend)
        return self.embed.attend(h), slot_counts, counts

    @torch.no_grad()
    def prefill_paged(
        self,
        pool: Dict[str, torch.Tensor],
        tokens: torch.Tensor,            # (B, C) one causal chunk
        block_tables: torch.Tensor,      # (B, M) int32
        q_start: torch.Tensor,           # (B,) int32
        q_len: torch.Tensor,             # (B,) int32 valid rows
        *,
        detectors: Optional[Dict] = None,
        policy: str = "zero",
        constant: float = 0.0,
        fills: Optional[Dict] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One prompt chunk straight off the pool.  Returns ``(logits
        (B, C, V) f32, slot_counts, counts)``; rows past ``q_len`` are
        garbage."""
        kw = self._fill_kw(detectors, fills, policy, constant)
        kp, vp = pool["layers/k"], pool["layers/v"]

        def attend(attn, x, layer):
            return attn.paged_prefill(
                x, kp, vp, block_tables, q_start, q_len, layer, **kw
            )

        h, slot_counts, counts = self._walk(self.embed(tokens), attend)
        return self.embed.attend(h), slot_counts, counts
