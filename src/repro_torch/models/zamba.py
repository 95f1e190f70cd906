"""Zamba2-style hybrid: a Mamba2 backbone with shared attention blocks
(reference ``models/zamba.py``).

``n_layers`` Mamba2 layers; after every ``mamba_per_attn``-th layer a
shared transformer block runs on ``concat(h, emb0)`` (the first embedding
re-injected, at width 2·d_model), its parameter set alternating as ``g %
n_shared_blocks``; each use has its own down-projection ``proj[g]`` (2·D,
D) back to d_model, an f32 product rounded once.  So the stack is G =
``n_layers // mamba_per_attn`` groups of (``mamba_per_attn`` Mamba layers +
one shared-block use), then ``n_tail`` Mamba layers.  Python loops over
the groups replace the reference's ``lax.scan``.

Ported surface: ``forward``, ``loss`` (under autograd; with ``cfg.remat``
each Mamba layer and each group recomputed in the backward, the
reference's nested ``jax.checkpoint``), ``cache_defs`` / ``init_cache``
and ``serve_step`` (one token through the Mamba states and the shared
blocks' dense KV caches).  The decode is strictly token by token
(``supports_batched_prefill = False``), so ``generate`` warms the cache one
prompt token at a time; there is no paged layout.

As in the reference, every module is built without a parameter path: each
weight read, the embedding's and both caches' included, is pathless, so
register mode and a pathless on-read rule repair them at the read; ``proj``
is read bare.  The shared attention's head dim is ``2·d_model // n_heads``
(224 at full width) and it runs the reference's ``jnp`` math outside any
kernel (``Attention.forward``: direct below 2,048 positions, chunked from
2,048 on).

Each weight lives in one contiguous tensor under the reference's path
(``param_tree``): ``mamba_groups/{norm,mamba}/...`` stacked (G,
mamba_per_attn, ...), ``shared/{norm1,attn,norm2,mlp}/...`` stacked
(n_shared_blocks, ...), ``proj`` (G, 2·D, D), ``mamba_tail/...`` (n_tail,
...), ``embed/table`` (tied) and ``final_norm/scale``; the layers'
parameters are its views, built on the meta device first.  ``bind_grads``
gives each one gradient buffer; a shared set's slot accumulates over every
group that uses it.  The decode cache is flat under the reference's paths:
``mamba_groups/{conv,ssm}`` (G, mamba_per_attn, B, ...), ``shared_kv/{k,v}``
(G, B, max_seq, n_kv, head dim) and ``mamba_tail/{conv,ssm}``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import device as device_lib
from ..configs.base import ArchConfig
from ..nn import initializers as ini
from ..nn.attention import Attention
from ..nn.layers import Embedding, RMSNorm, matmul_f32, param
from ..nn.mlp import SwiGLU
from ..nn.ssm import Mamba2
from .base import bind_stacked_grads, next_token_loss, stack_blocks

Cache = Dict[str, torch.Tensor]
_MAMBA_MODULES = ("norm", "mamba")
_SHARED_MODULES = ("norm1", "attn", "norm2", "mlp")


class MambaLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device,
                            rcfg=cfg.repair)
        self.mamba = Mamba2(cfg.d_model, d_state=cfg.ssm_state,
                            head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
                            dtype=cfg.dtype, device=device, rcfg=cfg.repair)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h + self.mamba(self.norm(h))


class SharedBlock(nn.Module):
    """The shared transformer block at width ``d_shared`` = 2·d_model."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, dt, rcfg = 2 * cfg.d_model, cfg.dtype, cfg.repair
        self.norm1 = RMSNorm(d, dtype=dt, device=device, rcfg=rcfg)
        self.attn = Attention(
            d, cfg.n_heads, cfg.n_kv, d // cfg.n_heads,
            rope_theta=cfg.rope_theta, dtype=dt, device=device, rcfg=rcfg,
            q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block,
        )
        self.norm2 = RMSNorm(d, dtype=dt, device=device, rcfg=rcfg)
        self.mlp = SwiGLU(d, cfg.d_ff, dtype=dt, device=device, rcfg=rcfg)


class ZambaLM(nn.Module):
    # recurrent decode consumes strictly one token per step
    supports_batched_prefill = False

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0):
        super().__init__()
        dev = device_lib.resolve(device)
        self.cfg = cfg
        self.n_groups = cfg.n_layers // cfg.mamba_per_attn
        self.n_tail = cfg.n_layers - self.n_groups * cfg.mamba_per_attn
        G, M, D = self.n_groups, cfg.mamba_per_attn, cfg.d_model
        self.embed = Embedding(cfg.vocab, D, dtype=cfg.dtype, device=dev,
                               rcfg=cfg.repair)
        meta = torch.device("meta")
        self.mamba_layers = nn.ModuleList(MambaLayer(cfg, meta) for _ in range(G * M))
        self.shared = nn.ModuleList(
            SharedBlock(cfg, meta) for _ in range(cfg.n_shared_blocks))
        self.tail = nn.ModuleList(MambaLayer(cfg, meta) for _ in range(self.n_tail))
        self.proj = param((G, 2 * D, D), cfg.dtype, dev)
        self.inits = {"proj": ini.fan_in()}
        self.final_norm = RMSNorm(D, dtype=cfg.dtype, device=dev, rcfg=cfg.repair)
        self._stacked = stack_blocks(self.mamba_layers, _MAMBA_MODULES,
                                     "mamba_groups", (G, M), device=dev)
        self._stacked.update(stack_blocks(self.shared, _SHARED_MODULES, "shared",
                                          (cfg.n_shared_blocks,), device=dev))
        if self.n_tail:
            self._stacked.update(stack_blocks(self.tail, _MAMBA_MODULES,
                                              "mamba_tail", (self.n_tail,),
                                              device=dev))
        self._grads: Optional[Dict[str, torch.Tensor]] = None
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def init_weights(self, seed: int) -> None:
        """Random weights under the reference's init scheme, drawn in module
        order from one generator seeded with ``seed`` on the weights'
        device."""
        ini.init_weights(self, seed, self.device)

    def mamba_layer(self, g: int, i: int) -> MambaLayer:
        return self.mamba_layers[g * self.cfg.mamba_per_attn + i]

    def shared_block(self, g: int) -> SharedBlock:
        """The parameter set group ``g`` uses (the reference's
        ``_select_shared``)."""
        return self.shared[g % self.cfg.n_shared_blocks]

    def param_tree(self) -> Dict[str, torch.Tensor]:
        """``{reference path: tensor}`` in the reference's leaf order, the
        model's own tensors (not copies)."""
        tree = dict(self._stacked)
        tree["proj"] = self.proj
        tree["embed/table"] = self.embed.table
        tree["final_norm/scale"] = self.final_norm.scale
        return {p: tree[p] for p in sorted(tree)}

    def _views(self, path: str):
        """The parameters that hold ``path``: the per-layer (or per-set)
        views of a stacked weight in order, or the one parameter."""
        stacks = {"mamba_groups": self.mamba_layers, "shared": self.shared,
                  "mamba_tail": self.tail}
        head, _, rest = path.partition("/")
        if head not in stacks:
            return [self.param_tree()[path]]
        mod, name = rest.split("/")
        return [getattr(getattr(blk, mod), name) for blk in stacks[head]]

    def bind_grads(self) -> Dict[str, torch.Tensor]:
        """Make the weights trainable and return ``{path: gradient}``: one
        zeroed buffer shaped like each ``param_tree`` leaf, whose slots are
        the views' ``.grad``; each shared set's slot sums the gradients of
        every group that uses it.  The serving entry points run without
        grad, so this changes nothing there."""
        if self._grads is None:
            self._grads = bind_stacked_grads(self.param_tree(), self._views)
        return self._grads

    # ---------------------------------------------------------------- forward
    def _shared_block(self, g: int, h, emb0, attend) -> torch.Tensor:
        """Group ``g``'s shared block on concat(h, emb0), projected back by
        ``proj[g]``; ``attend(attn, x)`` runs its attention (the forward's
        over positions, or the decode over the cached K/V)."""
        sb = self.shared_block(g)
        x = torch.cat([h, emb0], dim=-1)                     # (B, S, 2D)
        x = x + attend(sb.attn, sb.norm1(x))
        x = x + sb.mlp(sb.norm2(x))
        return h + matmul_f32(x, self.proj[g]).to(h.dtype)

    def _group(self, g: int, h, emb0, positions, remat: bool) -> torch.Tensor:
        for i in range(self.cfg.mamba_per_attn):
            layer = self.mamba_layer(g, i)
            h = checkpoint(layer, h, use_reentrant=False) if remat else layer(h)
        return self._shared_block(g, h, emb0, lambda attn, x: attn(x, positions))

    def _logits(self, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """(B, S) tokens -> f32 logits (B, S, V); S a multiple of
        ``min(ssm_chunk, S)``."""
        emb0 = self.embed(tokens)
        B, S = tokens.shape
        positions = torch.arange(S, device=emb0.device).expand(B, S)
        h = emb0
        for g in range(self.n_groups):
            if remat:
                h = checkpoint(self._group, g, h, emb0, positions, True,
                               use_reentrant=False)
            else:
                h = self._group(g, h, emb0, positions, False)
        for layer in self.tail:
            h = checkpoint(layer, h, use_reentrant=False) if remat else layer(h)
        return self.embed.attend(self.final_norm(h))

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens -> f32 logits (B, S, V)."""
        return self._logits(tokens)

    def loss(self, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token loss of ``batch["tokens"]`` (B, S) under autograd,
        as the reference's ``loss``: ``(scalar f32, {"loss", "accuracy",
        "tokens"})``, the metrics detached."""
        tokens = batch["tokens"]
        logits = self._logits(tokens, remat=self.cfg.remat
                              and torch.is_grad_enabled())
        loss, metrics = next_token_loss(logits, tokens)
        return loss, {k: v.detach() for k, v in metrics.items()}

    # ----------------------------------------------------------------- decode
    def cache_defs(self, batch: int, max_seq: int
                   ) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """``{path: (shape, dtype)}`` in the reference's flattened order."""
        G, M = self.n_groups, self.cfg.mamba_per_attn
        m = self.mamba_layers[0].mamba.cache_defs(batch)
        kv = self.shared[0].attn.cache_defs(batch, max_seq)
        defs = {f"mamba_groups/{k}": ((G, M) + shape, dt) for k, (shape, dt) in m.items()}
        defs.update({f"shared_kv/{k}": ((G,) + shape, dt) for k, (shape, dt) in kv.items()})
        if self.n_tail:
            defs.update({f"mamba_tail/{k}": ((self.n_tail,) + shape, dt)
                         for k, (shape, dt) in m.items()})
        return dict(sorted(defs.items()))

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """The decode cache, zeros: the Mamba states and the shared blocks'
        dense KV of ``max_seq`` positions."""
        return {
            path: torch.zeros(shape, dtype=dt, device=self.device)
            for path, (shape, dt) in self.cache_defs(batch, max_seq).items()
        }

    @staticmethod
    def _mamba_step(layer: MambaLayer, h, conv: torch.Tensor, ssm: torch.Tensor):
        y, new = layer.mamba.decode_step(layer.norm(h), {"conv": conv, "ssm": ssm})
        conv.copy_(new["conv"])
        ssm.copy_(new["ssm"])
        return h + y

    @torch.no_grad()
    def serve_step(self, cache: Cache, tokens: torch.Tensor,
                   pos) -> Tuple[torch.Tensor, Cache]:
        """One decode token per row at position ``pos`` (a scalar or (B,),
        read only by the shared attention): (B, 1) tokens -> ``(logits (B,
        1, V) f32, cache)``, the cache's tensors updated in place and the
        same dict returned."""
        emb0 = self.embed(tokens)
        h = emb0
        conv, ssm = cache["mamba_groups/conv"], cache["mamba_groups/ssm"]
        kc, vc = cache["shared_kv/k"], cache["shared_kv/v"]
        for g in range(self.n_groups):
            for i in range(self.cfg.mamba_per_attn):
                h = self._mamba_step(self.mamba_layer(g, i), h, conv[g, i], ssm[g, i])
            h = self._shared_block(g, h, emb0, lambda attn, x, g=g: attn.decode(
                x, kc[g], vc[g], pos))
        for j, layer in enumerate(self.tail):
            h = self._mamba_step(layer, h, cache["mamba_tail/conv"][j],
                                 cache["mamba_tail/ssm"][j])
        return self.embed.attend(self.final_norm(h)), cache

    def prefill(self, cache: Cache, tokens: torch.Tensor, pos=None):
        raise NotImplementedError(
            f"{type(self).__name__} decodes strictly token-by-token"
        )
