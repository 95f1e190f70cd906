"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory, sequential).

mLSTM recurrence (per head, d_k×d_v matrix memory — arXiv:2405.04517 §2.3):
    C_t = f_t C_{t-1} + i_t k_t v_tᵀ          n_t = f_t n_{t-1} + i_t k_t
    y_t = (q_tᵀ C_t) / max(|q_tᵀ n_t|, 1)
with exponential gating stabilized by the running max m_t and a
log-sigmoid forget gate.  ``MLSTM.forward`` (serving) runs the chunked
form through ``kernels.mlstm_chunk.mlstm_chunked`` (the reference wrote
that kernel as the drop-in for its ``_chunked_mlstm``, which it still
calls): fatal q/k/v lanes are repaired with the kernel's zero fill, the
identity on clean inputs, and ``W·v`` takes ``W`` in f32 where
``_chunked_mlstm`` casts it to the value dtype.  ``MLSTM.train_forward``
(training) runs ``_chunked_mlstm``, kept line for line, under autograd:
the reference's forward and its gradient, as the kernel has no backward.

sLSTM is inherently sequential (h_{t-1} feeds the gates through a
nonlinearity); it runs as a Python loop over time with per-head
block-diagonal recurrent weights.

Weights keep the reference's (in, out) layout and dtypes (``w_if``,
``b_if``, ``r`` and ``b`` in f32).  The reference reads every weight
through ``use``, the identity in memory mode: ``models.XLSTMLM`` refuses
the configurations where it is not.  The decode caches are flat dicts of
tensors; the mLSTM matrix memory C is the long-lived decode state (the
KV-cache analogue) that the serving scrub repairs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F_
from torch import nn

from ..kernels import mlstm_chunk
from . import initializers as ini
from .layers import param


def _mm(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` accumulated in f32, returned in ``dtype``."""
    return torch.matmul(x, w).to(dtype)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in f32 (the reference's
    ``preferred_element_type=f32`` with no cast after it)."""
    return torch.matmul(x.float(), w.float())


class MLSTM(nn.Module):
    def __init__(self, d_model: int, n_heads: int, *, proj_factor: float = 2.0,
                 conv_width: int = 4, chunk: int = 128,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.conv_width, self.chunk, self.dtype = conv_width, chunk, dtype
        self.d_inner = int(d_model * proj_factor)
        assert self.d_inner % n_heads == 0
        self.head_dim = self.d_inner // n_heads
        D, Din, H = d_model, self.d_inner, n_heads
        f32 = torch.float32
        self.w_up = param((D, 2 * Din), dtype, device)
        self.conv_w = param((conv_width, Din), dtype, device)
        self.conv_b = param((Din,), dtype, device)
        self.w_q = param((Din, Din), dtype, device)
        self.w_k = param((Din, Din), dtype, device)
        self.w_v = param((Din, Din), dtype, device)
        self.w_if = param((Din, 2 * H), f32, device)
        self.b_if = param((2 * H,), f32, device)
        self.norm_scale = param((Din,), dtype, device)
        self.w_down = param((Din, D), dtype, device)
        lin = ini.fan_in()
        self.inits = {
            "w_up": lin, "conv_w": ini.normal(0.1), "conv_b": ini.zeros,
            "w_q": lin, "w_k": lin, "w_v": lin, "w_if": ini.normal(0.02),
            "b_if": ini.zeros, "norm_scale": ini.ones, "w_down": lin,
        }

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        W = self.conv_width
        w = self.conv_w.float()
        b = self.conv_b.float()
        xf = x.float()
        pad = F_.pad(xf, (0, 0, W - 1, 0))
        out = sum(pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
                  for i in range(W))
        return F_.silu(out + b).to(self.dtype)

    def _qkvif(self, xc: torch.Tensor, x_inner: torch.Tensor):
        B, S, _ = xc.shape
        H, P = self.n_heads, self.head_dim
        q = _mm(xc, self.w_q, self.dtype)
        k = _mm(xc, self.w_k, self.dtype)
        v = _mm(x_inner, self.w_v, self.dtype)
        gif = _mm_f32(xc, self.w_if) + self.b_if
        q = (q.reshape(B, S, H, P) / (P ** 0.5)).to(self.dtype)
        k = k.reshape(B, S, H, P)
        v = v.reshape(B, S, H, P)
        log_i = gif[..., :H]                              # input gate, pre-exp
        log_f = F_.logsigmoid(gif[..., H:])               # forget gate ≤ 0
        return q, k, v, log_i, log_f

    def _out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Per-token norm, the z gate and the down projection."""
        scale = self.norm_scale.float()
        var = (y * y).mean(dim=-1, keepdim=True)
        y = y * torch.rsqrt(var + 1e-6) * scale
        y = (y * F_.silu(z.float())).to(self.dtype)
        return _mm(y, self.w_down, self.dtype)

    def _inputs(self, x: torch.Tensor):
        """(B, S, D) -> (q, k, v, log_i, log_f, z)."""
        up = _mm(x, self.w_up, self.dtype)
        x_inner, z = up[..., :self.d_inner], up[..., self.d_inner:]
        return (*self._qkvif(self._conv(x_inner), x_inner), z)

    def forward(self, x: torch.Tensor):
        """(B, S, D) -> ``(out (B, S, D), counts int32[8])``: the chunked
        kernel's repair counts (``kernels.mlstm_chunk`` layout)."""
        B, S, _ = x.shape
        q, k, v, log_i, log_f, z = self._inputs(x)
        y, counts = mlstm_chunk.mlstm_chunked(q, k, v, log_i, log_f,
                                              chunk=self.chunk)
        return self._out(y.reshape(B, S, self.d_inner), z), counts

    def train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, D) -> (B, S, D) under autograd through ``_chunked_mlstm``,
        the reference's own forward (it never calls its kernel)."""
        B, S, _ = x.shape
        q, k, v, log_i, log_f, z = self._inputs(x)
        y = _chunked_mlstm(q, k, v, log_i, log_f, chunk=self.chunk)
        return self._out(y.reshape(B, S, self.d_inner), z)

    # -------------------------------------------------------------- decode
    def cache_defs(self, batch: int):
        """``{name: (shape, dtype)}``; every leaf starts at zeros."""
        H, P, W = self.n_heads, self.head_dim, self.conv_width
        f32 = torch.float32
        return {
            "conv": ((batch, W - 1, self.d_inner), self.dtype),
            "C": ((batch, H, P, P), f32),
            "n": ((batch, H, P), f32),
            "m": ((batch, H), f32),
        }

    def decode_step(self, x: torch.Tensor, cache):
        """One token (B, 1, D) -> ``(out, new cache dict)``."""
        B = x.shape[0]
        up = _mm(x, self.w_up, self.dtype)
        x_inner, z = up[..., :self.d_inner], up[..., self.d_inner:]

        w = self.conv_w.float()
        b = self.conv_b.float()
        window = torch.cat([cache["conv"].float(), x_inner.float()], dim=1)
        xc = F_.silu(torch.einsum("bwc,wc->bc", window, w) + b)[:, None, :]
        xc = xc.to(self.dtype)
        new_conv = window[:, 1:, :].to(self.dtype)

        q, k, v, log_i, log_f = self._qkvif(xc, x_inner)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]               # (B, H, P)
        log_i, log_f = log_i[:, 0], log_f[:, 0]           # (B, H)

        C, n, m = cache["C"], cache["n"], cache["m"]
        m_new = torch.maximum(log_f + m, log_i)
        i_s = torch.exp(log_i - m_new)
        f_s = torch.exp(log_f + m - m_new)
        C = f_s[..., None, None] * C + i_s[..., None, None] * (
            k[..., :, None] * v[..., None, :]
        )
        n = f_s[..., None] * n + i_s[..., None] * k
        num = torch.einsum("bhp,bhpq->bhq", q.float(), C)
        # stabilized normalizer: max(|q·n~|, exp(−m)) (exp(m) factored out)
        den = torch.maximum(
            torch.einsum("bhp,bhp->bh", q.float(), n).abs(), torch.exp(-m_new)
        )
        y = (num / den[..., None]).reshape(B, 1, self.d_inner)
        out = self._out(y, z)
        return out, {"conv": new_conv, "C": C, "n": n, "m": m_new}


def _chunked_mlstm(q, k, v, log_i, log_f, *, chunk: int) -> torch.Tensor:
    """The reference's chunked-parallel mLSTM (``nn/xlstm.py:205``), line
    for line: per-chunk max stabilization, ``W`` cast to the value dtype
    before ``W·v``, no repair.  q, k, v (B, S, H, P); gates (B, S, H).
    Returns y (B, S, H, P) f32.  The train path (``MLSTM.train_forward``)
    and the tests' oracle twin."""
    B, S, H, P = q.shape
    Q = min(chunk, S)
    assert S % Q == 0
    nc = S // Q

    def r(x):
        return x.reshape(B, nc, Q, *x.shape[2:])

    qs, ks, vs = r(q), r(k), r(v)
    li, lf = r(log_i), r(log_f)
    F = torch.cumsum(lf, dim=2)                           # (B, nc, Q, H) ≤ 0
    F_end = F[:, :, -1, :]                                # (B, nc, H)
    b = li - F                                            # source exponents
    m_loc = b.amax(dim=2)                                 # (B, nc, H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()

    Cst = torch.zeros((B, H, P, P), dtype=torch.float32, device=q.device)
    nst = torch.zeros((B, H, P), dtype=torch.float32, device=q.device)
    m_prev = torch.full((B, H), -1e30, dtype=torch.float32, device=q.device)
    ys = []
    for c in range(nc):
        q_c, k_c, v_c = qs[:, c], ks[:, c], vs[:, c]
        b_c, F_c, Fe_c, ml_c = b[:, c], F[:, c], F_end[:, c], m_loc[:, c]
        m_star = torch.maximum(m_prev, ml_c)              # (B, H)

        src = torch.exp(b_c - m_star[:, None, :])         # (B, Q, H) ≤ 1
        qk = torch.einsum("bqhp,bkhp->bhqk", q_c.float(), k_c.float())
        W = qk * src.transpose(1, 2)[:, :, None, :]       # scale by source j
        W = torch.where(tri[None, None], W, 0.0)          # (B, H, q, k) f32
        num = torch.einsum("bhqk,bkhp->bqhp", W.to(v_c.dtype).float(),
                           v_c.float())
        den = W.sum(dim=-1).transpose(1, 2)               # (B, Q, H)

        resc = torch.exp(m_prev - m_star)                 # (B, H) ≤ 1
        num = num + torch.einsum("bqhp,bhpr,bh->bqhr", q_c.float(), Cst, resc)
        den = den + torch.einsum("bqhp,bhp,bh->bqh", q_c.float(), nst, resc)

        clamp = torch.exp(-F_c - m_star[:, None, :])      # = exp(−m_t)
        ys.append(num / torch.maximum(den.abs(), clamp)[..., None])

        Cst = resc[..., None, None] * Cst + torch.einsum(
            "bkh,bkhp,bkhr->bhpr", src, k_c.float(), v_c.float())
        nst = resc[..., None] * nst + torch.einsum(
            "bkh,bkhp->bhp", src, k_c.float())
        m_prev = Fe_c + m_star
    return torch.stack(ys, dim=1).reshape(B, S, H, P)


class SLSTM(nn.Module):
    """Scalar-memory LSTM with exponential gating and per-head
    block-diagonal recurrence (xLSTM §2.2), gate order [z, i, f, o]."""

    def __init__(self, d_model: int, n_heads: int, *, ff_factor: float = 4.0 / 3.0,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        assert d_model % n_heads == 0
        self.d_model, self.n_heads, self.dtype = d_model, n_heads, dtype
        self.head_dim = d_model // n_heads
        self.d_ff = int(d_model * ff_factor)
        D, H, P = d_model, n_heads, self.head_dim
        f32 = torch.float32
        self.w = param((D, 4 * D), dtype, device)
        self.r = param((H, P, 4 * P), f32, device)
        self.b = param((4 * D,), f32, device)
        self.norm_scale = param((D,), dtype, device)
        self.w_up = param((D, self.d_ff), dtype, device)
        self.w_down = param((self.d_ff, D), dtype, device)
        lin = ini.fan_in()
        self.inits = {
            "w": lin, "r": ini.normal(0.02), "b": ini.zeros,
            "norm_scale": ini.ones, "w_up": lin, "w_down": lin,
        }

    def _cell(self, pre, state):
        """One step.  pre: (B, H, P, 4) input preactivations; state =
        (c, n, m, h), each (B, H, P) f32."""
        c, n, m, h = state
        rec = torch.einsum("bhp,hpq->bhq", h, self.r)     # (B, H, 4P)
        B, H, P = h.shape
        z_pre, i_pre, f_pre, o_pre = (pre + rec.reshape(B, H, P, 4)).unbind(-1)
        z = torch.tanh(z_pre)
        o = torch.sigmoid(o_pre)
        log_f = F_.logsigmoid(f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        i_s = torch.exp(i_pre - m_new)
        f_s = torch.exp(log_f + m - m_new)
        c_new = f_s * c + i_s * z
        n_new = f_s * n + i_s
        h_new = o * c_new / torch.maximum(n_new.abs(), torch.exp(-m_new))
        return (c_new, n_new, m_new, h_new)

    def _pre(self, x):
        B, S, D = x.shape
        H, P = self.n_heads, self.head_dim
        pre = _mm_f32(x, self.w) + self.b
        # (B, S, 4D) -> (B, S, H, P, 4): gates are blocked per head
        return pre.reshape(B, S, 4, H, P).permute(0, 1, 3, 4, 2)

    def _ffn(self, y):
        scale = self.norm_scale.float()
        var = (y * y).mean(dim=-1, keepdim=True)
        y = (y * torch.rsqrt(var + 1e-6) * scale).to(self.dtype)
        hcat = _mm_f32(y, self.w_up)
        hcat = F_.gelu(hcat, approximate="tanh").to(self.dtype)
        return _mm(hcat, self.w_down, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        H, P = self.n_heads, self.head_dim
        pre = self._pre(x)                                # (B, S, H, P, 4)
        z = torch.zeros((B, H, P), dtype=torch.float32, device=x.device)
        state = (z, z, torch.full_like(z, -1e30), z)
        hs = []
        for t in range(S):
            state = self._cell(pre[:, t], state)
            hs.append(state[3])
        y = torch.stack(hs, dim=1).reshape(B, S, D)       # f32
        return self._ffn(y)

    # -------------------------------------------------------------- decode
    def cache_defs(self, batch: int):
        st = ((batch, self.n_heads, self.head_dim), torch.float32)
        return {"c": st, "n": st, "m": st, "h": st}

    def decode_step(self, x: torch.Tensor, cache):
        B = x.shape[0]
        pre = self._pre(x)[:, 0]                          # (B, H, P, 4)
        state = tuple(cache[k] for k in ("c", "n", "m", "h"))
        c, n, m, h = self._cell(pre, state)
        out = self._ffn(h.reshape(B, 1, self.d_model))
        return out, {"c": c, "n": n, "m": m, "h": h}
