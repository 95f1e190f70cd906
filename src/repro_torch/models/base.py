"""Shared model pieces: the causal LM loss (reference
``models/base.py::next_token_loss``) and the stacked weight layout both
families train on (``stack_blocks``, ``bind_stacked_grads``)."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


def next_token_loss(
    logits: torch.Tensor,                 # (B, S, V)
    tokens: torch.Tensor,                 # (B, S) integer
    mask: Optional[torch.Tensor] = None,  # (B, S): which *targets* count
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss in f32: predict ``tokens[:, t+1]`` from
    ``logits[:, t]``, logsumexp minus the gold logit, averaged over the
    counted targets.  Returns ``(loss, {"loss", "accuracy", "tokens"})``."""
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    if mask is None:
        m = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
    else:
        m = mask[:, 1:].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    nll = (logz - gold) * m
    denom = m.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    acc = (logits.argmax(dim=-1) == targets).float()
    return loss, {
        "loss": loss,
        "accuracy": (acc * m).sum() / denom,
        "tokens": m.sum(),
    }


def owner_of(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    """The submodule that holds the parameter ``name`` (``router.w`` or
    ``router/w``) of ``module``, and its own name there."""
    *heads, leaf = name.replace("/", ".").split(".")
    for h in heads:
        module = getattr(module, h)
    return module, leaf


def stack_blocks(blocks: Sequence[nn.Module], modules: Sequence[str],
                 prefix: str, lead: Tuple[int, ...],
                 device=None) -> Dict[str, torch.Tensor]:
    """One contiguous tensor per block weight, shaped ``lead`` + the
    weight's shape, under the reference's path ``prefix/module/name`` (a
    nested module's parameter under ``prefix/module/sub/name``), on
    ``device`` (default: the blocks' own); each block's parameter becomes
    the view of its slot (the blocks in row-major order over ``lead``).
    Blocks built on the meta device take no memory before their weights
    are stacked."""
    stacked = {}
    for mod in modules:
        for name, p0 in getattr(blocks[0], mod).named_parameters():
            whole = torch.empty(tuple(lead) + tuple(p0.shape), dtype=p0.dtype,
                                device=p0.device if device is None else device)
            rows = whole.view((-1,) + tuple(p0.shape))
            for blk, row in zip(blocks, rows):
                owner, leaf = owner_of(getattr(blk, mod), name)
                setattr(owner, leaf, nn.Parameter(row, requires_grad=False))
            stacked[f"{prefix}/{mod}/{name.replace('.', '/')}"] = whole
    return stacked


def bind_stacked_grads(tree: Dict[str, torch.Tensor],
                       views: Callable[[str], List[nn.Parameter]]
                       ) -> Dict[str, torch.Tensor]:
    """Make the weights trainable and return ``{path: gradient}``: one
    zeroed buffer shaped like each ``tree`` leaf, whose slots are the
    ``.grad`` of the parameters ``views(path)`` gives, so the backward
    accumulates into it in place."""
    grads = {}
    for path, leaf in tree.items():
        buf = torch.zeros_like(leaf)
        params = views(path)
        for p, g in zip(params, buf.view((len(params),) + tuple(params[0].shape))):
            p.requires_grad_(True)
            p.grad = g
        grads[path] = buf
    return grads
