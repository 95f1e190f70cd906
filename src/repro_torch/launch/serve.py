"""Greedy generation over a model's decode cache, with the serving
runtime's periodic cache scrub.

The cache is the approximate-memory resident.  ``generate`` owns one
``ApproxSpace`` per run (``serve_space``): memory-forced, NaN/Inf-only, and
scrubbing the whole cache every ``scrub_every`` steps — the memory-
repairing mechanism applied to the recurrent state, cheaper than leaving a
NaN resident to poison every later token (Table 3's temporal analogue).

``generate`` prefills a transformer's dense cache in one batched pass and
warms a recurrent cache (the xLSTM's, Zamba's Mamba states and shared KV)
one token at a time; ``paged=True`` rebases the run onto the serving
engine, one request per prompt row.
"""
from __future__ import annotations

import warnings
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


def scrub_cache(model, cache, stats=None, space: Optional[ApproxSpace] = None):
    """Memory-mode repair of the decode cache, one shot, in place: ``(cache,
    stats')``.  ``space`` defaults to ``serve_space(model)``.

    Deprecated shim: delegates to a memory-forced ``ApproxSpace.scrub``."""
    warnings.warn(
        "launch.serve.scrub_cache is a deprecated shim; use "
        "runtime.ApproxSpace.scrub (README §Migration)",
        DeprecationWarning,
        stacklevel=2,
    )
    stats = stats if stats is not None else stats_lib.zeros()
    space = space or serve_space(model)
    return space.scrub(cache, stats)


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
    page_size: int = 16,
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """Greedy generation: returns ``(tokens (B, S0 + max_new), stats)``.

    A transformer (``supports_batched_prefill``) prefills its dense cache of
    ``max_seq`` positions in one pass; a recurrent model warms its cache
    one prompt token at a time (the xLSTM ignores ``max_seq``; Zamba's
    shared attention keeps a dense KV of ``max_seq`` positions).  Before every
    step ``t`` (the batched prefill is step 0) the space's schedule may
    scrub the whole cache (``scrub_every``; trigger "interval"); the
    run's stats are returned and recorded into ``space``
    (default: ``serve_space(model, scrub_every)``).

    ``paged=True`` serves each prompt row as one engine request over a
    paged pool instead (``_generate_paged``)."""
    B, S0 = prompt.shape
    if max_new <= 0:
        return prompt, stats_lib.as_dict(stats_lib.zeros())
    if paged:
        return _generate_paged(
            model, prompt, max_new=max_new, max_seq=max_seq,
            page_size=page_size, scrub_every=scrub_every, space=space,
        )
    space = space or serve_space(model, scrub_every)
    batched = model.supports_batched_prefill
    cache = model.init_cache(B, max_seq)
    step_fn = space.wrap_serve_step(build_serve_step(model))
    stats = stats_lib.zeros()
    tokens = prompt.to(model.device)
    nxt, t0 = tokens[:, :1], 0
    if batched:
        if space.config.scrub.due(0):
            cache, stats = space.scrub(cache, stats, trigger="interval")
        nxt_flat, _, cache, stats = step_fn(cache, tokens, 0, stats)
        nxt = nxt_flat[:, None].to(tokens.dtype)
        tokens = torch.cat([tokens, nxt], dim=1)
        t0 = S0
    for t in range(t0, S0 + max_new - 1):
        tok = tokens[:, t:t + 1] if t < S0 else nxt
        if space.config.scrub.due(t):
            cache, stats = space.scrub(cache, stats, trigger="interval")
        nxt_flat, _, cache, stats = step_fn(cache, tok, t, stats)
        nxt = nxt_flat[:, None].to(tokens.dtype)
        if t >= S0 - 1:
            tokens = torch.cat([tokens, nxt], dim=1)
    space.record(stats)
    return tokens, stats_lib.as_dict(stats)


def _generate_paged(
    model,
    prompt: torch.Tensor,
    *,
    max_new: int,
    max_seq: int,
    page_size: int,
    scrub_every: int = 0,
    space: Optional[ApproxSpace] = None,
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """``generate`` over the serving engine: one request per prompt row, a
    pool sized so that nothing waits.  ``scrub_every`` becomes the engine's
    background sweep over the whole pool; a given ``space`` receives the
    run's unified stats."""
    from ..serving import Engine, ServingConfig  # deferred: serving imports us

    B = prompt.shape[0]
    page_size = min(page_size, max_seq)
    while max_seq % page_size:
        page_size -= 1
    pages_per_req = max_seq // page_size
    n_pages = B * pages_per_req
    eng = Engine(
        model,
        ServingConfig(
            page_size=page_size, n_pages=n_pages, max_batch=B,
            max_pages_per_request=pages_per_req, sweep_interval=scrub_every,
            sweep_pages=n_pages,
        ),
        device=model.device,
    )
    rows = prompt.cpu().numpy()
    rids = [eng.add_request(rows[b], max_new=max_new) for b in range(B)]
    results = eng.run()
    if space is not None:
        space.record(eng.unified_stats())
    out = torch.tensor([results[r]["tokens"] for r in rids], dtype=prompt.dtype,
                       device=model.device)
    return out, eng.stats_dict()
