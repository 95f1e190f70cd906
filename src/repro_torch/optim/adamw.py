"""AdamW with decoupled weight decay and global-norm clipping (reference
``optim/adamw.py``), over the port's flat state.

State: ``{"step": int32 0-d, "mu/<path>": f32, "nu/<path>": f32}``, the
moments shaped like the parameters they follow.  The moments live in the
approximate region (a flipped moment perturbs one update; a NaN is the
boundary scrub's to repair), ``step`` in the exact region (its path pins
it there).  Moments are f32 whatever the parameters' dtype, the update
math is f32 in the reference's order (the ``nu`` clamp included), and the
parameters are written back in their own dtype, in place.
``torch.optim.AdamW`` is not this arithmetic: it has no clamp and puts eps
elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]   # schedule(step) -> f32
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params: Tree) -> Tree:
        """Zero moments for ``{path: parameter}`` and step 0."""
        dev = next(iter(params.values())).device
        state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
        for name in ("mu", "nu"):
            for path, p in params.items():
                state[f"{name}/{path}"] = torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device)
        return state

    @torch.no_grad()
    def update(self, grads: Tree, state: Tree, params: Tree) -> Tree:
        """One step, in place on ``params`` and ``state``.  Returns the
        metrics ``{"grad_norm", "lr"}`` (f32 0-d tensors)."""
        gnorm = _global_norm(grads.values())
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-12), max=1.0)
        state["step"].add_(1)
        step = state["step"].float()
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - torch.pow(b1, step)
        c2 = 1.0 - torch.pow(b2, step)
        lr = self.lr(state["step"])
        for path, p in params.items():
            g = grads[path].float()
            if scale is not None:
                g = g * scale
            m, v = state[f"mu/{path}"], state[f"nu/{path}"]
            m.copy_(b1 * m + (1 - b1) * g)
            # nu ≥ 0: a flipped sign bit is finite drift the NaN scrub
            # leaves alone, and sqrt of it would poison the update
            v.copy_(b2 * torch.clamp_min(v, 0.0) + (1 - b2) * g * g)
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        return {"grad_norm": gnorm, "lr": lr}


def _global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares, the
    leaf sums added in order."""
    total = None
    for g in leaves:
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)
