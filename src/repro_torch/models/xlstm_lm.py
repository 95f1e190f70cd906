"""xLSTM LM: mLSTM blocks with a periodic sLSTM block (arXiv:2405.04517).

Every ``slstm_every``-th block is sLSTM, the rest mLSTM: with 48 blocks
and ``slstm_every`` 8 the stack is 6 groups of (7 mLSTM + 1 sLSTM).  Python
loops over the groups replace the reference's nested ``lax.scan``.  Both
block types are pre-norm residual and carry their own projections (no
external FFN).

Ported surface: ``forward`` (the prefill path: the chunked mLSTM kernel
runs once per mLSTM block), ``serve_step`` (one decode token through the
recurrent cache), ``init_cache``, the tied readout, and training
(``loss``: the trunk under autograd through the reference's own chunked
mLSTM, ``nn.xlstm._chunked_mlstm``, as the kernel has no backward; with
``cfg.remat`` each mLSTM block and each group recomputed in the backward,
the reference's nested ``jax.checkpoint``).

Each block weight lives in one contiguous tensor under the reference's
stacked path (``param_tree``): (n_groups, m_per_group, ...) for the mLSTM
blocks' ``mlstm_groups/{norm,mlstm}/...``, (n_groups, ...) for the sLSTM
blocks' ``slstm_layers/{norm,slstm}/...``; the blocks' parameters are its
views, so the train state, the scrub, the injection and the optimizer act
on the blocks' bytes, and ``bind_grads`` gives each weight one gradient
buffer.  The decode cache is
a flat dict under the reference's paths (``mlstm_groups/C``,
``slstm_layers/h``, …), leaves stacked (n_groups, m_per_group, …) for the
mLSTM blocks and (n_groups, …) for the sLSTM blocks, as the reference's
``cache_defs`` stacks them, so a scrub sees the same leaves (and counts on
the same tile grid) as the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import device as device_lib
from ..configs.base import ArchConfig
from ..core import rules as rules_lib
from ..nn import initializers as ini
from ..nn.layers import Embedding, RMSNorm
from ..nn.xlstm import MLSTM, SLSTM
from .base import bind_stacked_grads, next_token_loss, stack_blocks

Cache = Dict[str, torch.Tensor]


class MBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.mlstm = MLSTM(cfg.d_model, cfg.n_heads, chunk=cfg.ssm_chunk,
                           dtype=cfg.dtype, device=device)


class SBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.slstm = SLSTM(cfg.d_model, cfg.n_heads, dtype=cfg.dtype,
                           device=device)


class XLSTMLM(nn.Module):
    # recurrent decode consumes strictly one token per step
    supports_batched_prefill = False

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0):
        super().__init__()
        if cfg.n_layers % cfg.slstm_every:
            raise ValueError(f"xLSTM stack must be whole groups: {cfg.n_layers} "
                             f"blocks, slstm_every {cfg.slstm_every}")
        read = rules_lib.ruleset_of(cfg.repair).read_rule()
        if cfg.repair.mode == "register" or read.trigger == "on-read":
            raise NotImplementedError(
                "use-site repair of the xLSTM weights (register mode, on-read "
                "rules) is not ported: ROADMAP slice 5 (the other families)"
            )
        dev = device_lib.resolve(device)
        self.cfg = cfg
        self.n_groups = cfg.n_layers // cfg.slstm_every
        self.m_per_group = cfg.slstm_every - 1
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype=cfg.dtype, device=dev)
        self.mlstm_layers = nn.ModuleList(
            MBlock(cfg, dev) for _ in range(self.n_groups * self.m_per_group))
        self.slstm_layers = nn.ModuleList(
            SBlock(cfg, dev) for _ in range(self.n_groups))
        self.final_norm = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=dev)
        G, M = self.n_groups, self.m_per_group
        self._stacked = stack_blocks(self.mlstm_layers, ("norm", "mlstm"),
                                     "mlstm_groups", (G, M))
        self._stacked.update(stack_blocks(self.slstm_layers, ("norm", "slstm"),
                                          "slstm_layers", (G,)))
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

    def mblock(self, g: int, i: int) -> MBlock:
        return self.mlstm_layers[g * self.m_per_group + i]

    def param_tree(self) -> Dict[str, torch.Tensor]:
        """``{reference path: tensor}`` in the reference's leaf order: the
        tied table, the final norm and the stacked block weights, the
        model's own tensors (not copies)."""
        tree = dict(self._stacked)
        tree["embed/table"] = self.embed.table
        tree["final_norm/scale"] = self.final_norm.scale
        return {p: tree[p] for p in sorted(tree)}

    def _views(self, path: str):
        """The parameters that hold ``path``: the per-block views of a
        stacked weight in block order, or the one parameter."""
        if path == "embed/table":
            return [self.embed.table]
        if path == "final_norm/scale":
            return [self.final_norm.scale]
        stack, mod, name = path.split("/")
        blocks = self.mlstm_layers if stack == "mlstm_groups" else self.slstm_layers
        return [getattr(getattr(blk, mod), name) for blk in blocks]

    def bind_grads(self) -> Dict[str, torch.Tensor]:
        """Make the weights trainable and return ``{path: gradient}``: one
        zeroed buffer shaped like each ``param_tree`` leaf, whose per-block
        slots are the views' ``.grad``.  The serving entry points run
        without grad, so this changes nothing there."""
        if self._grads is None:
            self._grads = bind_stacked_grads(self.param_tree(), self._views)
        return self._grads

    # ---------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, with_counts: bool = False):
        """(B, S) tokens -> f32 logits (B, S, V); with ``with_counts`` also
        the mLSTM kernel's repair counts, int32[8] summed over blocks."""
        h = self.embed(tokens)
        counts = torch.zeros(8, dtype=torch.int32, device=h.device)
        for g in range(self.n_groups):
            for i in range(self.m_per_group):
                blk = self.mblock(g, i)
                y, c = blk.mlstm(blk.norm(h))
                h = h + y
                counts += c
            blk = self.slstm_layers[g]
            h = h + blk.slstm(blk.norm(h))
        logits = self.embed.attend(self.final_norm(h))
        return (logits, counts) if with_counts else logits

    def loss(self, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token loss of ``batch["tokens"]`` (B, S) under autograd,
        as the reference's ``loss``: ``(scalar f32, {"loss", "accuracy",
        "tokens"})``, the metrics detached.  The mLSTM blocks run
        ``MLSTM.train_forward``; with ``cfg.remat`` each mLSTM block and
        each group is recomputed in the backward (non-reentrant
        checkpoints, nested as the reference nests ``jax.checkpoint``)."""
        tokens = batch["tokens"]
        remat = self.cfg.remat and torch.is_grad_enabled()
        h = self.embed(tokens)
        for g in range(self.n_groups):
            if remat:
                h = checkpoint(self._train_group, g, h, True,
                               use_reentrant=False)
            else:
                h = self._train_group(g, h, False)
        logits = self.embed.attend(self.final_norm(h))
        loss, metrics = next_token_loss(logits, tokens)
        return loss, {k: v.detach() for k, v in metrics.items()}

    @staticmethod
    def _train_mblock(blk: MBlock, h: torch.Tensor) -> torch.Tensor:
        return h + blk.mlstm.train_forward(blk.norm(h))

    def _train_group(self, g: int, h: torch.Tensor, remat: bool) -> torch.Tensor:
        for i in range(self.m_per_group):
            blk = self.mblock(g, i)
            if remat:
                h = checkpoint(self._train_mblock, blk, h, use_reentrant=False)
            else:
                h = self._train_mblock(blk, h)
        blk = self.slstm_layers[g]
        return h + blk.slstm(blk.norm(h))

    # ----------------------------------------------------------------- decode
    def cache_defs(self, batch: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """``{path: (shape, dtype)}`` in the reference's flattened order."""
        G, M = self.n_groups, self.m_per_group
        m = self.mlstm_layers[0].mlstm.cache_defs(batch)
        s = self.slstm_layers[0].slstm.cache_defs(batch)
        defs = {f"mlstm_groups/{k}": ((G, M) + shape, dt)
                for k, (shape, dt) in m.items()}
        defs.update({f"slstm_layers/{k}": ((G,) + shape, dt)
                     for k, (shape, dt) in s.items()})
        return dict(sorted(defs.items()))

    def init_cache(self, batch: int, max_seq: Optional[int] = None) -> Cache:
        """The decode cache: every leaf zeros, as the reference's.  The
        recurrent state has no sequence axis: ``max_seq`` is accepted, as
        the transformer's signature has it, and ignored."""
        return {
            path: torch.zeros(shape, dtype=dt, device=self.device)
            for path, (shape, dt) in self.cache_defs(batch).items()
        }

    @torch.no_grad()
    def serve_step(self, cache: Cache, tokens: torch.Tensor,
                   pos=None) -> Tuple[torch.Tensor, Cache]:
        """One decode token per row: (B, 1) tokens -> ``(logits (B, 1, V)
        f32, cache)``.  The cache's tensors are updated in place (the
        reference returns a new cache) and the same dict is returned; the
        position is implicit in the recurrent state."""
        h = self.embed(tokens)
        m_names = [p.split("/")[1] for p in cache if p.startswith("mlstm_groups/")]
        s_names = [p.split("/")[1] for p in cache if p.startswith("slstm_layers/")]
        for g in range(self.n_groups):
            for i in range(self.m_per_group):
                blk = self.mblock(g, i)
                state = {k: cache[f"mlstm_groups/{k}"][g, i] for k in m_names}
                y, new = blk.mlstm.decode_step(blk.norm(h), state)
                h = h + y
                for k in m_names:
                    state[k].copy_(new[k])
            blk = self.slstm_layers[g]
            state = {k: cache[f"slstm_layers/{k}"][g] for k in s_names}
            y, new = blk.slstm.decode_step(blk.norm(h), state)
            h = h + y
            for k in s_names:
                state[k].copy_(new[k])
        return self.embed.attend(self.final_norm(h)), cache

    def prefill(self, cache: Cache, tokens: torch.Tensor, pos=None):
        raise NotImplementedError(
            f"{type(self).__name__} decodes strictly token-by-token"
        )
