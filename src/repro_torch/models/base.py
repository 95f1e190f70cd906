"""Shared model pieces: the causal LM loss (reference
``models/base.py::next_token_loss``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


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
