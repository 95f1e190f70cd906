"""Mamba2 block in the chunked SSD (state-space dual) form (reference
``nn/ssm.py``).

Recurrence per head h, with a scalar decay:

    h_t = a_t · h_{t-1} + Δ_t · B_t ⊗ x_t          a_t = exp(Δ_t · A_h) ∈ (0, 1)
    y_t = C_t · h_t + D_h · x_t

``forward`` runs the whole sequence through ``_chunked_ssd``: within a
chunk plain products, across chunks a short loop over the chunk summaries.
``decode_step`` advances the carried state one token at a time.  No Pallas
kernel is involved in the reference, so none here.

Rounding points, as the reference's: the in and out projections are f32
products rounded once to the dtype (``matmul_f32``); the depthwise conv,
the softplus, the SSD and the gated norm run in f32; ``y`` is rounded to
the dtype before the gated norm.  The SSM state is f32, the conv state is in
the dtype.  Every weight and both cache leaves are read through pathless
use sites (the reference calls ``use`` with no path), so register mode and
a pathless on-read rule repair them at the read.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import initializers as ini
from .layers import UseSites, matmul_f32, param

_WEIGHTS = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
            "norm_scale", "out_proj")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class Mamba2(nn.Module):
    def __init__(self, d_model: int, *, d_state: int = 64, head_dim: int = 64,
                 expand: int = 2, conv_width: int = 4, chunk: int = 128,
                 dtype=torch.bfloat16, device=None, rcfg: Any = None):
        super().__init__()
        self.d_model, self.d_state, self.head_dim = d_model, d_state, head_dim
        self.conv_width, self.chunk, self.dtype = conv_width, chunk, dtype
        self.d_inner = expand * d_model
        if self.d_inner % head_dim:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of "
                             f"head_dim {head_dim}")
        self.n_heads = self.d_inner // head_dim
        self.conv_channels = self.d_inner + 2 * d_state
        D, Din, N, H = d_model, self.d_inner, d_state, self.n_heads
        self.in_proj = param((D, 2 * Din + 2 * N + H), dtype, device)  # [z, x, B, C, dt]
        self.conv_w = param((conv_width, self.conv_channels), dtype, device)
        self.conv_b = param((self.conv_channels,), dtype, device)
        self.A_log = param((H,), torch.float32, device)
        self.D = param((H,), torch.float32, device)
        self.dt_bias = param((H,), torch.float32, device)
        self.norm_scale = param((Din,), dtype, device)
        self.out_proj = param((Din, D), dtype, device)
        self.inits = {
            "in_proj": ini.fan_in(), "conv_w": ini.normal(0.1),
            "conv_b": ini.zeros, "A_log": ini.ones, "D": ini.ones,
            "dt_bias": ini.zeros, "norm_scale": ini.ones,
            "out_proj": ini.fan_in(),
        }
        self.reads = UseSites(rcfg, "", _WEIGHTS)
        self.cache_reads = UseSites(rcfg, "", ("conv", "ssm"))

    # ------------------------------------------------------------- pieces
    def _w(self, name: str) -> torch.Tensor:
        return self.reads.read(name, getattr(self, name))

    def _split_proj(self, x: torch.Tensor):
        Din, N = self.d_inner, self.d_state
        proj = matmul_f32(x, self._w("in_proj")).to(self.dtype)
        z = proj[..., :Din]
        xBC = proj[..., Din:2 * Din + 2 * N]
        dt_raw = proj[..., 2 * Din + 2 * N:]                 # (B, S, H)
        return z, xBC, dt_raw

    def _conv(self, xBC: torch.Tensor) -> torch.Tensor:
        """Causal depthwise conv over (B, S, C), width W, in f32; the taps
        summed in the reference's order."""
        W, S = self.conv_width, xBC.shape[1]
        w = self._w("conv_w").float()                        # (W, C)
        b = self._w("conv_b").float()
        pad = F.pad(xBC.float(), (0, 0, W - 1, 0))
        out = 0
        for i in range(W):
            out = out + pad[:, i:i + S, :] * w[i][None, None, :]
        return F.silu(out + b).to(self.dtype)

    def _gated_norm(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        scale = self._w("norm_scale").float()
        yf = y.float()
        var = (yf * yf).mean(dim=-1, keepdim=True)
        yn = yf * torch.rsqrt(var + 1e-6) * scale
        return (yn * F.silu(z.float())).to(self.dtype)

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        return matmul_f32(y, self._w("out_proj")).to(self.dtype)

    # ------------------------------------------------------ full sequence
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, D) -> (B, S, D); S a multiple of ``min(chunk, S)``."""
        B, S, _ = x.shape
        N, H, P, Din = self.d_state, self.n_heads, self.head_dim, self.d_inner
        z, xBC, dt_raw = self._split_proj(x)
        xBC = self._conv(xBC)
        xs = xBC[..., :Din].reshape(B, S, H, P)
        Bm = xBC[..., Din:Din + N]
        Cm = xBC[..., Din + N:]
        A = -torch.exp(self._w("A_log"))                     # (H,) < 0
        dt = _softplus(dt_raw.float() + self._w("dt_bias"))  # (B, S, H)
        y = _chunked_ssd(xs.float(), Bm.float(), Cm.float(), dt, A,
                         chunk=self.chunk)                   # (B, S, H, P) f32
        y = y + self._w("D")[None, None, :, None] * xs.float()
        y = y.reshape(B, S, Din).to(self.dtype)
        return self._out(self._gated_norm(y, z))

    # -------------------------------------------------------------- decode
    def cache_defs(self, batch: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """``conv`` (B, W-1, C) in the dtype, ``ssm`` (B, H, N, P) f32."""
        return {
            "conv": ((batch, self.conv_width - 1, self.conv_channels), self.dtype),
            "ssm": ((batch, self.n_heads, self.d_state, self.head_dim),
                    torch.float32),
        }

    def decode_step(self, x: torch.Tensor, cache: Dict[str, torch.Tensor]):
        """One token: x (B, 1, D) -> ``(y (B, 1, D), {"conv", "ssm"})``,
        the new state (the caller writes it back).  O(1) in the context."""
        B = x.shape[0]
        N, H, P, Din = self.d_state, self.n_heads, self.head_dim, self.d_inner
        z, xBC, dt_raw = self._split_proj(x)
        conv_state = self.cache_reads.read("conv", cache["conv"])   # (B, W-1, C)
        w = self._w("conv_w").float()
        b = self._w("conv_b").float()
        window = torch.cat([conv_state.float(), xBC.float()], dim=1)  # (B, W, C)
        conv_out = F.silu(torch.einsum("bwc,wc->bc", window, w) + b)
        new_conv = window[:, 1:, :].to(self.dtype)
        xs = conv_out[:, :Din].reshape(B, H, P)
        Bm = conv_out[:, Din:Din + N]
        Cm = conv_out[:, Din + N:]
        A = -torch.exp(self._w("A_log"))
        dt = _softplus(dt_raw[:, 0].float() + self._w("dt_bias"))   # (B, H)
        a = torch.exp(dt * A)
        h = self.cache_reads.read("ssm", cache["ssm"])              # (B, H, N, P)
        h = a[..., None, None] * h + torch.einsum("bn,bh,bhp->bhnp", Bm, dt, xs)
        y = torch.einsum("bn,bhnp->bhp", Cm, h)
        y = y + self._w("D")[None, :, None] * xs
        y = y.reshape(B, 1, Din).to(self.dtype)
        return self._out(self._gated_norm(y, z)), {"conv": new_conv, "ssm": h}


def _chunked_ssd(x, Bm, Cm, dt, A, *, chunk: int) -> torch.Tensor:
    """Chunked scan for ``h_t = a_t h_{t-1} + (dt_t B_t) ⊗ x_t``, ``y_t =
    C_t · h_t`` (reference ``_chunked_ssd``).

    x (B, S, H, P) f32; Bm, Cm (B, S, N); dt (B, S, H); A (H,).  Returns y
    (B, S, H, P) f32.  The intra-chunk decay is ``where(tri, exp(dLa), 0)``
    as the reference's: above the diagonal ``dLa >= 0`` and ``exp`` may
    overflow to inf there, which the forward drops and the backward turns
    into NaN (``0 · inf``) in both packages."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    nc = S // Q
    xs = x.reshape(B, nc, Q, H, P)
    Bs = Bm.reshape(B, nc, Q, N)
    Cs = Cm.reshape(B, nc, Q, N)
    dts = dt.reshape(B, nc, Q, H)

    log_a = dts * A[None, None, None, :]                     # (B, nc, Q, H) <= 0
    La = torch.cumsum(log_a, dim=2)                          # inclusive
    u = xs * dts[..., None]                                  # Δ_t x_t

    # intra-chunk: M_{iq,jk} = (C_i · B_j) exp(La_i - La_j), j <= i
    CB = torch.einsum("bcqn,bckn->bcqk", Cs, Bs)
    dLa = La[:, :, :, None, :] - La[:, :, None, :, :]        # (B, nc, q, k, H)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri[None, None, :, :, None], torch.exp(dLa),
                        torch.zeros((), dtype=dLa.dtype, device=x.device))
    M = CB[..., None] * decay
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, u)

    # chunk summaries
    La_end = La[:, :, -1, :]                                 # (B, nc, H)
    decay_to_end = torch.exp(La_end[:, :, None, :] - La)     # (B, nc, Q, H)
    S_c = torch.einsum("bckn,bckh,bckhp->bchnp", Bs, decay_to_end, u)
    a_chunk = torch.exp(La_end)                              # (B, nc, H)

    # cross-chunk state scan: the state *before* each chunk
    h = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = a_chunk[:, c, :, None, None] * h + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B, nc, H, N, P)

    # inter-chunk: exp(La_i) decays the chunk's starting state to step i
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cs, torch.exp(La), h_prevs)
    return (y_intra + y_inter).reshape(B, S, H, P)
