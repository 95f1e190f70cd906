"""The paper's two fused-repair ops with memory-mode semantics (§3.3 /
§3.4):

  register mode   repair inside the kernel only; the stored operand keeps
                  its NaN and every call re-detects it (Table 3: N events)
  memory mode     the same, plus: when an operand's event counter is above
                  0, that operand is scrubbed once at its origin
                  (``kernels.scrub``), so later calls see clean data
                  (Table 3: exactly one event)

The origin scrub writes back IN PLACE into the caller's tensor: the
returned ``a``/``b`` (``k``/``v``) are the caller's tensors, repaired.  A
caller that must keep the poisoned operand passes a clone.  Register mode
never modifies its operands.  The reference decides the scrub on the
device with ``lax.cond``; here the decision costs one host read of the
int32[8] counts after the call (none in register mode).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import repair_attention as _ra
from . import repair_matmul as _rm
from . import scrub as _scrub

scrub = _scrub.scrub
scrub_pages = _scrub.scrub_pages

MM_NAN_A, MM_INF_A, MM_EV_A = _rm.NAN_A, _rm.INF_A, _rm.EV_A
MM_NAN_B, MM_INF_B, MM_EV_B = _rm.NAN_B, _rm.INF_B, _rm.EV_B
MM_EV_TOTAL = _rm.EV_TOTAL
AT_NAN_K, AT_INF_K, AT_EV_K = _ra.NAN_K, _ra.INF_K, _ra.EV_K
AT_NAN_V, AT_INF_V, AT_EV_V = _ra.NAN_V, _ra.INF_V, _ra.EV_V
AT_EV_TOTAL = _ra.EV_TOTAL

_MODES = ("register", "memory")


class MatmulResult(NamedTuple):
    c: torch.Tensor
    a: torch.Tensor         # post-call operand (scrubbed in place in memory mode)
    b: torch.Tensor
    counts: torch.Tensor    # int32[8], MM_* layout


class AttentionResult(NamedTuple):
    out: torch.Tensor
    k: torch.Tensor         # post-call cache (scrubbed in place in memory mode)
    v: torch.Tensor
    counts: torch.Tensor    # int32[8], AT_* layout


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode must be register|memory, got {mode!r}")


def _reactive_scrub(operands, counts, slots, **kw) -> None:
    """Scrub each operand in place whose event counter fired (one host read
    of ``counts`` for all of them)."""
    fired = counts.tolist()
    for x, slot in zip(operands, slots):
        if fired[slot] > 0:
            _scrub.scrub(x, **kw)


def repair_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mode: str = "memory",
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
    blocks: Optional[Tuple[int, int, int]] = None,
    out_dtype: Optional[torch.dtype] = None,
    detector=None,
) -> MatmulResult:
    """c = a @ b with fused reactive repair of both operands; memory mode
    scrubs a poisoned operand in place at its origin."""
    _check_mode(mode)
    c, counts = _rm.repair_matmul_raw(
        a, b, policy=policy, constant=constant, include_inf=include_inf,
        blocks=blocks, out_dtype=out_dtype, detector=detector,
    )
    if mode == "memory":
        _reactive_scrub((a, b), counts, (MM_EV_A, MM_EV_B), policy=policy,
                        constant=constant, include_inf=include_inf,
                        detector=detector)
    return MatmulResult(c, a, b, counts)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mode: str = "memory",
    causal: bool = True,
    policy: str = "zero",
    constant: float = 0.0,
    include_inf: bool = True,
    blocks: Optional[Tuple[int, int]] = None,
    detector=None,
) -> AttentionResult:
    """Flash attention with fused reactive repair of the cached K/V; memory
    mode scrubs a poisoned K or V in place at its origin."""
    _check_mode(mode)
    out, counts = _ra.flash_attention_raw(
        q, k, v, causal=causal, policy=policy, constant=constant,
        include_inf=include_inf, blocks=blocks, detector=detector,
    )
    if mode == "memory":
        _reactive_scrub((k, v), counts, (AT_EV_K, AT_EV_V), policy=policy,
                        constant=constant, include_inf=include_inf,
                        detector=detector)
    return AttentionResult(out, k, v, counts)
