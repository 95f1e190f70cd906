"""Greedy generation over a model's decode cache, with the serving
runtime's periodic cache scrub.

The cache is the approximate-memory resident.  ``generate`` owns one
``ApproxSpace`` per run (``serve_space``): memory-forced, NaN/Inf-only, and
scrubbing the whole cache every ``scrub_every`` steps — the memory-
repairing mechanism applied to the recurrent state, cheaper than leaving a
NaN resident to poison every later token (Table 3's temporal analogue).

Ported: ``build_serve_step``, ``serve_space`` and the contiguous (non-
paged) ``generate`` with the token-by-token warm-up of recurrent models.
The paged rebase (``paged=True``) and the gathered-view transformer step
are ROADMAP items.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core import stats as stats_lib
from ..runtime import ApproxSpace, ScrubSchedule


def build_serve_step(model) -> Callable:
    """``serve_step(cache, tokens, pos) -> (next_token, logits, cache)``.

    Multi-token inputs take the batched prefill path (``model.prefill``),
    single tokens the decode step, so the greedy step cannot drift between
    callers."""

    def serve_step(cache, tokens, pos):
        fn = model.prefill if tokens.shape[1] > 1 else model.serve_step
        logits, cache = fn(cache, tokens, pos)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt, logits, cache

    return serve_step


# One serving space per (model config, cadence): its region and plan
# caches and unified stats stream persist across calls.
_SPACE_CACHE: Dict[Any, ApproxSpace] = {}


def serve_space(model, scrub_every: int = 0, *, memoize: bool = True) -> ApproxSpace:
    """The serving runtime for ``model``: its repair config, memory-forced
    (a poisoned cache must be repairable even in register-mode runs),
    NaN/Inf-only (``max_magnitude=None``: cache lanes are not O(1) like
    weights) and the periodic-scrub cadence.  Memoized per (model config,
    cadence); ``memoize=False`` returns a private space.  A config carrying
    an explicit ``RuleSet`` keeps it."""
    key = (model.cfg, scrub_every) if memoize else None
    try:
        space = _SPACE_CACHE.get(key) if key is not None else None
    except TypeError:           # unhashable custom config — skip memoization
        key, space = None, None
    if space is None:
        space = ApproxSpace(
            model.cfg.repair, mode="memory", max_magnitude=None,
            scrub=ScrubSchedule(boundary=False, interval=scrub_every),
        )
        if key is not None:
            _SPACE_CACHE[key] = space
    return space


@torch.no_grad()
def generate(
    model,
    prompt: torch.Tensor,       # (B, S0) int
    *,
    max_new: int,
    max_seq: int,
    scrub_every: int = 0,
    space: Optional[ApproxSpace] = None,
    paged: bool = False,
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """Greedy generation: returns ``(tokens (B, S0 + max_new), stats)``.

    Recurrent models (``supports_batched_prefill`` False) warm their cache
    one prompt token at a time.  Before every step ``t`` the space's
    schedule may scrub the whole cache (``scrub_every``; trigger
    "interval"); the run's stats are returned and recorded into ``space``
    (default: ``serve_space(model, scrub_every)``).  ``max_seq`` is the
    reference's cache length, which a recurrent cache does not have."""
    if paged:
        raise NotImplementedError(
            "generate(paged=True) is not ported: ROADMAP 'Serving leftovers' "
            "item 5 (the serving engine serves paged models)"
        )
    if getattr(model, "supports_batched_prefill", True) or not hasattr(
            model, "init_cache"):
        raise NotImplementedError(
            f"generate over {type(model).__name__} is not ported: ROADMAP "
            "'Serving leftovers' item 5 (build_serve_step's gathered-view "
            "path); use serving.Engine"
        )
    B, S0 = prompt.shape
    if max_new <= 0:
        return prompt, stats_lib.as_dict(stats_lib.zeros())
    space = space or serve_space(model, scrub_every)
    cache = model.init_cache(B)
    step_fn = space.wrap_serve_step(build_serve_step(model))
    stats = stats_lib.zeros()
    tokens = prompt.to(model.device)
    nxt = tokens[:, :1]
    for t in range(S0 + max_new - 1):
        tok = tokens[:, t:t + 1] if t < S0 else nxt
        if space.config.scrub.due(t):
            cache, stats = space.scrub(cache, stats, trigger="interval")
        nxt_flat, _, cache, stats = step_fn(cache, tok, t, stats)
        nxt = nxt_flat[:, None].to(tokens.dtype)
        if t >= S0 - 1:
            tokens = torch.cat([tokens, nxt], dim=1)
    space.record(stats)
    return tokens, stats_lib.as_dict(stats)
