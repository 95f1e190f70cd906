"""Mixture-of-Experts with top-k token-choice routing (the reference's
``nn/moe.py``), step for step:

  route      the router's f32 logits (TF32 left off), NaN → -1e30, the top k
             with ties to the lower expert index (``top_k``), the gates a
             softmax of the k values in f32, the Switch-style aux loss
  slots      an exclusive count over the (S·k) slots of a group, token-major
             then k: a slot is kept below the capacity C
             (``MoE.capacity``); ``dest`` is its row in the group's (E·C)
             buffer, E·C when dropped (``slots``)
  dispatch   the kept slots scattered into one (E, B·C, D) buffer of the
             model's dtype, expert-major, so each expert's weights are read
             once a call
  experts    a SwiGLU over every expert, whatever its rows hold: ``g``,
             ``u`` and ``y`` f32 products (``nn.layers.bmm_f32``), ``silu(g)
             · u`` and ``y`` rounded once to the dtype
  combine    each slot gathers row ``min(dest, E·C - 1)`` of its group (a
             dropped slot gathers the last row and multiplies it by 0, NaN
             included), scaled by ``gate · keep`` in the dtype, summed over
             k in f32 and rounded once

Approximate-memory integration (README §Regions): the expert weights are
the big, cold, read-mostly approximate-memory resident and are read through
the use-site repair with no path (the reference calls ``use`` with none),
so only a pathless rule binds them.  The router is pinned to the exact
region by its path (``core.regions``: ``layers/mlp/router/w``) and is read
bare; its NaN logits are neutralised before the top k, so a fault can never
corrupt the routing table.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import initializers as ini
from .layers import UseSites, bmm_f32, param

NEG_INF = -1e30
_WEIGHTS = ("w_gate", "w_up", "w_down")


class Router(nn.Module):
    """The routing table ``w`` (D, E), f32, exact region."""

    def __init__(self, d_model: int, n_experts: int, *, device=None):
        super().__init__()
        self.w = param((d_model, n_experts), torch.float32, device)
        self.inits = {"w": ini.normal(0.02)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, D) -> f32 logits (B, S, E), NaN replaced by -1e30.  An
        exact f32 product on the card needs TF32 off, which is the caller's
        setting (``torch.backends.cuda.matmul.allow_tf32``, off by default):
        TF32 moves the top-k set."""
        logits = torch.matmul(x.float(), self.w)
        return torch.where(torch.isnan(logits), NEG_INF, logits)


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest logits and their expert ids, ties to the lower id (as
    ``jax.lax.top_k``; ``torch.topk`` breaks ties in no stated order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def slots(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """``(keep, dest)`` of each of a group's S·k slots, token-major then k
    (``expert_idx`` (B, S, k)): slot i keeps when fewer than ``capacity``
    earlier slots of its group chose its expert, and lands in row ``expert
    · capacity + that count`` of the group's (E·C) buffer, ``E·C`` when
    dropped.  Both (B, S·k)."""
    B = expert_idx.shape[0]
    flat = expert_idx.reshape(B, -1)
    onehot = F.one_hot(flat, n_experts).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(-1, flat[..., None])[..., 0]
    keep = pos < capacity
    dest = torch.where(keep, flat * capacity + pos, n_experts * capacity)
    return keep, dest


class MoE(nn.Module):
    """``x`` (B, S, D) -> ``(out (B, S, D), aux)``; groups are the batch
    rows, S tokens each."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25, *, dtype=torch.bfloat16,
                 device=None, rcfg: Any = None):
        super().__init__()
        self.n_experts, self.k = n_experts, top_k
        self.capacity_factor = capacity_factor
        E, D, Fd = n_experts, d_model, d_ff
        self.router = Router(D, E, device=device)
        self.w_gate = param((E, D, Fd), dtype, device)
        self.w_up = param((E, D, Fd), dtype, device)
        self.w_down = param((E, Fd, D), dtype, device)
        self.inits = {n: ini.fan_in() for n in _WEIGHTS}
        self.reads = UseSites(rcfg, "", _WEIGHTS)

    def capacity(self, tokens_per_group: int) -> int:
        return max(self.k, int(math.ceil(
            self.k * tokens_per_group / self.n_experts * self.capacity_factor)))

    def route(self, x: torch.Tensor):
        """``(gates (B, S, k) f32, expert_idx (B, S, k), aux)``."""
        E = self.n_experts
        logits = self.router(x)
        vals, idx = top_k(logits, self.k)
        gates = torch.softmax(vals, dim=-1)
        me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
        ce = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
        return gates, idx, (me * ce).sum() * E

    def experts(self, buf: torch.Tensor) -> torch.Tensor:
        """The SwiGLU of every expert over its rows: (E, N, D) -> (E, N, D)
        in the buffer's dtype."""
        read = self.reads.read
        g = bmm_f32(buf, read("w_gate", self.w_gate))
        u = bmm_f32(buf, read("w_up", self.w_up))
        h = (F.silu(g) * u).to(buf.dtype)
        return bmm_f32(h, read("w_down", self.w_down)).to(buf.dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, D = x.shape
        E, k = self.n_experts, self.k
        C = self.capacity(S)
        dt = self.w_gate.dtype
        gates, idx, aux = self.route(x)
        keep, dest = slots(idx, E, C)
        # the reference's row dest of group b is row (e, b, c) of the
        # expert-major buffer; a dropped slot goes to the extra last row
        b = torch.arange(B, device=x.device)[:, None]
        rows = torch.where(keep, (dest // C) * (B * C) + b * C + dest % C, E * B * C)
        buf = torch.zeros(E * B * C + 1, D, dtype=dt, device=x.device)
        buf.index_add_(0, rows.reshape(-1), x.repeat_interleave(k, dim=1)
                       .to(dt).reshape(-1, D))
        y = self.experts(buf[:-1].view(E, B * C, D)).view(E * B * C, D)
        safe = dest.clamp(max=E * C - 1)
        gathered = y[(safe // C) * (B * C) + b * C + safe % C]     # (B, S·k, D)
        w = gates.reshape(B, S * k) * keep.float()
        out = gathered * w[..., None].to(dt)
        return out.view(B, S, k, D).float().sum(dim=2).to(dt), aux
