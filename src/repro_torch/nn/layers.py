"""Basic layers: ``Linear``, RMSNorm, LayerNorm and the token embedding
with its tied readout, and the use-site read every layer's weights go
through.

Every module declares ``inits`` — ``{parameter name: initializer}`` — which
``nn.initializers.init_weights`` draws from one generator.  Weights
keep the reference's (in, out) layout, so a product is ``x @ w`` and the
weights carry across from the JAX package without transposes.

Use-site repair (the paper's register mode, and on-read rules in any mode):
each module takes the model's repair config ``rcfg`` and its parameter path
prefix (``layers/attn``, ``embed``, ...), and reads each weight through
``core.repair.use`` with the reference's path.  Whether a read can ever
repair depends on ``rcfg`` and the path alone (``runtime.space.read_rule``),
so each module decides it once, at construction (``read_site``): where it
cannot, the read is the bare tensor with no call at all.

Products the reference forms with ``preferred_element_type=f32`` go through
``matmul_f32`` (``bmm_f32`` for a stack of experts), which keeps them in
f32 until the caller rounds, once.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..core import repair
from ..runtime import ApproxSpace
from ..runtime.space import read_rule
from . import initializers as ini


def param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(
        torch.empty(shape, dtype=dtype, device=device), requires_grad=False
    )


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cuda":
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


class _MatmulF32(torch.autograd.Function):
    """The f32 product of 16-bit operands with the reference's transpose:
    the f32 cotangent, never rounded first, times the other operand widened
    to f32 (exact), each gradient rounded once to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g2, b.float().t()).to(a.dtype).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            a2 = a.reshape(-1, a.shape[-1]).float()
            gb = torch.matmul(a2.t(), g2).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``a`` (..., K), ``b`` (K, N)) with an f32 result.

    16-bit operands on the card: one GEMM with f32 output
    (``torch.mm(..., out_dtype=torch.float32)``), so the product is rounded
    once, by the caller, and the weights are read in their own dtype.  On
    the CPU: the f32 product of the same values (each 16-bit product is
    exact in f32; only the summation order differs from the reference).
    Under autograd the backward keeps the f32 cotangent (``_MatmulF32``):
    ``dA = round(g @ bᵀ)``, ``dB = round(aᵀ @ g)``, the products in f32.
    f32 operands: the plain product and its own backward (TF32 stays off)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32.apply(a, b)
    return _mm_f32(a, b)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _BmmF32(torch.autograd.Function):
    """``_MatmulF32`` for each batch: the f32 cotangent times the other
    operand widened to f32, each gradient rounded once."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The batched ``matmul_f32``: ``a`` (E, N, K) @ ``b`` (E, K, M) with
    an f32 result (E, N, M), rounded once, by the caller.  16-bit operands
    on the card: one ``torch.bmm(..., out_dtype=torch.float32)``; on the
    CPU the f32 product of the same values; under autograd ``_BmmF32``.
    f32 operands: the plain product and its own backward."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _BmmF32.apply(a, b)
    return _bmm_f32(a, b)


def sub_path(prefix: str, name: str) -> str:
    """The reference's parameter path ``prefix/name``; "" (a pathless read,
    bound to ``RuleSet.read_rule``) when the module has no prefix."""
    return f"{prefix}/{name}" if prefix else ""


def read_site(rcfg: Any, path: str) -> Optional[ApproxSpace]:
    """``None`` where a use-site read of ``path`` under ``rcfg`` can never
    repair, else one prebuilt space for ``core.repair.use``."""
    if rcfg is None or read_rule(rcfg, path) is None:
        return None
    return ApproxSpace(rcfg)


class UseSites:
    """The read sites of one module's weights, decided at construction."""

    def __init__(self, rcfg: Any, prefix: str, names):
        self.paths = {n: sub_path(prefix, n) for n in names}
        self.sites = {n: read_site(rcfg, p) for n, p in self.paths.items()}

    def read(self, name: str, x: torch.Tensor) -> torch.Tensor:
        site = self.sites[name]
        if site is None:
            return x
        return repair.use(x, site, path=self.paths[name])


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, eps: float = 1e-6, dtype=torch.bfloat16,
                 device=None, rcfg: Any = None, path: str = ""):
        super().__init__()
        self.eps = eps
        self.scale = param((d,), dtype, device)
        self.inits = {"scale": ini.ones}
        self.reads = UseSites(rcfg, path, ("scale",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.reads.read("scale", self.scale)
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """The reference's LayerNorm: mean and variance in f32, ``y·scale +
    bias`` in f32, rounded once to the input dtype."""

    def __init__(self, d: int, *, eps: float = 1e-5, dtype=torch.bfloat16,
                 device=None, rcfg: Any = None, path: str = ""):
        super().__init__()
        self.eps = eps
        self.scale = param((d,), dtype, device)
        self.bias = param((d,), dtype, device)
        self.inits = {"scale": ini.ones, "bias": ini.zeros}
        self.reads = UseSites(rcfg, path, ("scale", "bias"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.reads.read("scale", self.scale)
        bias = self.reads.read("bias", self.bias)
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * scale.float() + bias.float()).to(x.dtype)


class Linear(nn.Module):
    """``y = x @ w``, ``w`` (d_in, d_out) with fan-in init: the product in
    f32, rounded once to ``x.dtype`` (the reference's bias-free
    ``Linear``, the untied head's only form)."""

    def __init__(self, d_in: int, d_out: int, *, dtype=torch.bfloat16,
                 device=None, rcfg: Any = None, path: str = ""):
        super().__init__()
        self.w = param((d_in, d_out), dtype, device)
        self.inits = {"w": ini.fan_in()}
        self.reads = UseSites(rcfg, path, ("w",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return matmul_f32(x, self.reads.read("w", self.w)).to(x.dtype)


class Embedding(nn.Module):
    """Token embedding (vocab, d); also the tied readout."""

    def __init__(self, vocab: int, d_model: int, *, dtype=torch.bfloat16,
                 device=None, rcfg: Any = None, path: str = ""):
        super().__init__()
        self.table = param((vocab, d_model), dtype, device)
        self.inits = {"table": ini.normal(0.02)}
        self.reads = UseSites(rcfg, path, ("table",))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.reads.read("table", self.table)[tokens.long()]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied readout: logits = x @ table.T, the f32 product."""
        return matmul_f32(x, self.reads.read("table", self.table).t())
