"""Decoder-only transformer LM: the dense family (Qwen2, StarCoder2,
StableLM, Mistral-Large), the MoE family (Qwen3-MoE, Phi-3.5-MoE) and the
VLM backbone (LLaVA-NeXT-Mistral-7B: precomputed patch embeddings prefix
the tokens in ``forward`` and ``loss``; serving takes tokens only, as in
the reference).

A Python loop over per-layer blocks replaces the reference's ``lax.scan``;
the layer index reaches the kernels as an argument, so one kernel serves
every layer.  Ported surface: ``forward`` (the whole sequence), the dense
cache (``cache_defs``, ``init_cache``, ``serve_step``, ``prefill``), the
paged paths (``serve_step_paged``: one decode token per request;
``prefill_paged``: one causal prompt chunk), final norm and the readout
(``_readout``: the tied table's f32 product, or an untied ``lm_head``
whose product is rounded to the activations' dtype before it is widened
to f32, as the reference's ``Linear`` does), and training (``loss``: the
whole sequence under autograd, each block recomputed in the backward with
``cfg.remat``).  Every block reads
its weights through the use-site repair of ``cfg.repair`` with the
reference's parameter paths (``layers/attn/wq``, ``embed/table``, ...).
The config picks the norm (``rms``: RMSNorm, ``ln``: LayerNorm), the MLP
(``swiglu``, or ``gelu``: the GeLU MLP with biases; with ``n_experts`` the
``nn.moe.MoE`` block, whatever ``mlp`` says), the QKV bias, the rotary
fraction and the head's tying.  An MoE block returns its load-balance aux
term beside its output: ``loss`` adds ``0.01 ·`` the sum over layers (and
reports it as ``moe_aux``); the serving paths drop it.

Each layer weight lives in one contiguous (L, ...) tensor, the reference's
stacked leaf (``param_tree``; the router's ``layers/mlp/router/w`` too);
the blocks' parameters are its per-layer views.  So the train state, the
scrub, the injection and the optimizer act on the same bytes as the
blocks, one tensor a weight, and ``bind_grads`` gives every weight one
(L, ...) gradient buffer whose slices are the views' ``.grad``.  The
blocks are built on the meta device, so building a model allocates its
weights' bytes once.

The dense cache is the pool's flat-keyed layout: ``{"layers/k",
"layers/v"}`` of shape (L, B, S, Kh, Dh), what ``PagedKVPool.gather``
returns.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import device as device_lib
from ..configs.base import ArchConfig
from ..nn import initializers as ini
from ..nn.attention import Attention
from ..nn.layers import Embedding, LayerNorm, Linear, RMSNorm
from ..nn.mlp import GeluMLP, SwiGLU
from ..nn.moe import MoE
from .base import bind_stacked_grads, next_token_loss, owner_of, stack_blocks

_BLOCK_MODULES = ("norm1", "attn", "norm2", "mlp")
# the modules outside the blocks whose parameters are ``param_tree`` leaves
_TOP_MODULES = ("embed", "final_norm", "lm_head")


def _norm(cfg: ArchConfig, device, path: str):
    norm = RMSNorm if cfg.norm == "rms" else LayerNorm
    return norm(cfg.d_model, dtype=cfg.dtype, device=device, rcfg=cfg.repair,
                path=path)


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dt, rcfg = cfg.dtype, cfg.repair
        self.norm1 = _norm(cfg, device, "layers/norm1")
        self.attn = Attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta,
            rotary_pct=cfg.rotary_pct, dtype=dt, device=device, rcfg=rcfg,
            path="layers/attn", q_block=cfg.attn_q_block,
            kv_block=cfg.attn_kv_block,
        )
        self.norm2 = _norm(cfg, device, "layers/norm2")
        if cfg.n_experts:
            self.mlp = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k,
                           cfg.capacity_factor, dtype=dt, device=device,
                           rcfg=rcfg)
        else:
            mlp = GeluMLP if cfg.mlp == "gelu" else SwiGLU
            self.mlp = mlp(cfg.d_model, cfg.d_ff, dtype=dt, device=device,
                           rcfg=rcfg, path="layers/mlp")

    def ffn(self, x: torch.Tensor):
        """``(y, aux)``: the MLP's output and an MoE block's aux term (None
        for a dense block)."""
        y = self.mlp(x)
        return y if isinstance(self.mlp, MoE) else (y, None)


class TransformerLM(nn.Module):
    supports_paged_kv = True
    supports_paged_decode = True
    supports_paged_prefill = True
    # the decode path is length-generic: one serve_step call over the whole
    # prompt is a batched prefill
    supports_batched_prefill = True

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0):
        super().__init__()
        dev = device_lib.resolve(device)
        if cfg.n_experts and dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            warnings.warn("TF32 is on: the MoE router's f32 logits are not exact, "
                          "and its top-k set may differ from the reference's")
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype=cfg.dtype,
                               device=dev, rcfg=cfg.repair, path="embed")
        meta = torch.device("meta")
        self.layers = nn.ModuleList(Block(cfg, meta) for _ in range(cfg.n_layers))
        self.final_norm = _norm(cfg, dev, "final_norm")
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab, dtype=cfg.dtype,
                                  device=dev, rcfg=cfg.repair, path="lm_head")
        # one (L, ...) tensor per layer weight, the blocks' parameters its views
        self._stacked = stack_blocks(self.layers, _BLOCK_MODULES, "layers",
                                     (cfg.n_layers,), device=dev)
        self._grads: Optional[Dict[str, torch.Tensor]] = None
        self.init_weights(seed)

    def param_tree(self) -> Dict[str, torch.Tensor]:
        """``{reference path: tensor}`` in the reference's leaf order: the
        embedding table, the final norm, an untied head's ``lm_head/w`` and
        the stacked layer weights, the model's own tensors (not copies)."""
        tree = dict(self._stacked)
        for mod in _TOP_MODULES:
            if hasattr(self, mod):
                for name, p in getattr(self, mod).named_parameters(recurse=False):
                    tree[f"{mod}/{name}"] = p
        return {p: tree[p] for p in sorted(tree)}

    def _views(self, path: str):
        """The parameters that hold ``path``: the per-layer views of a
        stacked weight, or the one parameter."""
        if not path.startswith("layers/"):
            return [getattr(*owner_of(self, path))]
        name = path[len("layers/"):]
        return [getattr(*owner_of(blk, name)) for blk in self.layers]

    def bind_grads(self) -> Dict[str, torch.Tensor]:
        """Make the weights trainable and return ``{path: gradient}``: one
        zeroed buffer shaped like each ``param_tree`` leaf, whose per-layer
        slices are the views' ``.grad``, so the backward accumulates into
        it in place.  The serving entry points run without grad, so this
        changes nothing there."""
        if self._grads is None:
            self._grads = bind_stacked_grads(self.param_tree(), self._views)
        return self._grads

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

    def cache_defs(self, batch: int, max_seq: int):
        """``{"layers/k": (shape, dtype), "layers/v": ...}``, each leaf
        ``(n_layers, batch, max_seq, Kh, Dh)``."""
        defs = self.layers[0].attn.cache_defs(batch, max_seq)
        return {f"layers/{name}": ((self.cfg.n_layers,) + shape, dt)
                for name, (shape, dt) in defs.items()}

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, torch.Tensor]:
        """The dense decode cache, zeros."""
        return {
            path: torch.zeros(shape, dtype=dt, device=self.device)
            for path, (shape, dt) in self.cache_defs(batch, max_seq).items()
        }

    @staticmethod
    def _block(blk: Block, h: torch.Tensor, positions: torch.Tensor):
        h = h + blk.attn(blk.norm1(h), positions)
        y, aux = blk.ffn(blk.norm2(h))
        return h + y, aux

    def _embed_inputs(self, tokens: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor] = None):
        """``(h, positions, n_prefix)``: the token embeddings, with a VLM's
        patch prefix (B, P, D) cast to their dtype and put before them, and
        positions over all P + S rows (the reference's ``_embed_inputs``)."""
        h = self.embed(tokens)
        n_prefix = 0
        if patch_embeds is not None:
            n_prefix = patch_embeds.shape[1]
            h = torch.cat([patch_embeds.to(h.dtype), h], dim=1)
        positions = torch.arange(h.shape[1], device=h.device).expand(h.shape[:2])
        return h, positions, n_prefix

    def _logits(self, tokens: torch.Tensor, remat: bool = False,
                patch_embeds: Optional[torch.Tensor] = None):
        """(B, S) tokens -> ``(f32 logits (B, S, V), aux)``, causal over the
        whole sequence (``Attention.forward``, ``impl="auto"``); ``aux`` is
        the MoE blocks' aux terms summed in f32 (0 for a dense model).  A
        patch prefix runs through the trunk and is dropped before the
        readout, so the logits are the tokens' alone.
        With ``remat`` each block is recomputed in the backward
        (non-reentrant checkpoint, the reference's ``jax.checkpoint``)."""
        h, positions, n_prefix = self._embed_inputs(tokens, patch_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for blk in self.layers:
            if remat:
                h, a = checkpoint(self._block, blk, h, positions,
                                  use_reentrant=False)
            else:
                h, a = self._block(blk, h, positions)
            if a is not None:
                aux = aux + a
        return self._readout(self.final_norm(h)[:, n_prefix:]), aux

    def _readout(self, h: torch.Tensor) -> torch.Tensor:
        """f32 logits of the final hidden ``h``: the tied table's f32
        product, or the untied head's product rounded to ``h.dtype`` (the
        reference's ``Linear``) and widened to f32."""
        if self.cfg.tie_embeddings:
            return self.embed.attend(h)
        return self.lm_head(h).float()

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *,
                patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) tokens -> f32 logits (B, S, V); a VLM's ``patch_embeds``
        (B, P, D) prefix the tokens in the trunk."""
        return self._logits(tokens, patch_embeds=patch_embeds)[0]

    def loss(self, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token loss of ``batch["tokens"]`` (B, S) under autograd,
        as the reference's ``loss``: ``(scalar f32, {"loss", "accuracy",
        "tokens"})``, the metrics detached; an MoE model adds ``0.01 ·
        aux`` to the loss and ``moe_aux`` to the metrics.  A VLM batch's
        ``patch_embeds`` prefix the tokens; the loss runs over the tokens
        only."""
        tokens = batch["tokens"]
        logits, aux = self._logits(tokens, remat=self.cfg.remat
                                   and torch.is_grad_enabled(),
                                   patch_embeds=batch.get("patch_embeds"))
        loss, metrics = next_token_loss(logits, tokens)
        if self.cfg.n_experts:
            loss = loss + 0.01 * aux
            metrics = dict(metrics, moe_aux=aux)
        return loss, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def serve_step(self, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   pos) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(B, S) tokens written at ``pos`` (a scalar or (B,)) of the dense
        cache, updated in place: S == 1 decodes, S > 1 is a batched prefill.
        Returns ``(logits (B, S, V) f32, cache)``."""
        kc, vc = cache["layers/k"], cache["layers/v"]
        h = self.embed(tokens)
        for i, blk in enumerate(self.layers):
            h = h + blk.attn.decode(blk.norm1(h), kc[i], vc[i], pos)
            h = h + blk.ffn(blk.norm2(h))[0]
        return self._readout(self.final_norm(h)), cache

    def prefill(self, cache, tokens, pos):
        """The whole prompt in one ``serve_step`` call."""
        return self.serve_step(cache, tokens, pos)

    def _walk(self, h, attend):
        """Run the layers; ``attend(attn, x, layer)`` is the paged attention
        call.  Returns (final hidden, slot_counts, counts) summed over
        layers."""
        slot_acc = counts_acc = None
        for i, blk in enumerate(self.layers):
            a, slot, cnt = attend(blk.attn, blk.norm1(h), i)
            h = h + a
            h = h + blk.ffn(blk.norm2(h))[0]
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
        return self._readout(h), slot_counts, counts

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
        return self._readout(h), slot_counts, counts
