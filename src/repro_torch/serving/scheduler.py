"""Continuous-batching scheduler: admit -> prefill -> decode -> finish/evict.

A FIFO waiting queue, admission control against free pages, per-step page
growth for running requests, and preemption under page pressure: the victim
is always the newest running request, and only if newer than the one that
needs the page.  With a ``TierManager`` (``host_pages > 0``,
``swap_policy="swap"``) the victim's pages are swapped out to the host
tier and it re-admits onto fresh pages without a re-prefill; otherwise, or
when the host store is full, it frees its pages and rejoins the head of the
queue with its generated tokens folded into its prefill prompt.  With a
``PrefixCache``, admission shares the longest cached prefix's pages and
allocates only the rest, and allocation evicts cache-only pages before it
gives up.  Pure host-side bookkeeping; the device work lives in the engine.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Any, List, Optional

from .config import ServingConfig
from .pool import PagedKVPool


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request and its page-mapped cache footprint."""

    rid: int
    prompt: List[int]
    max_new: int
    state: RequestState = RequestState.WAITING
    tokens: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0                       # next cache write position
    slot: Optional[int] = None         # decode batch slot while RUNNING
    prefill_pos: Optional[int] = None  # chunked-prefill progress
    n_preempted: int = 0
    truncated: bool = False
    cached_tokens: int = 0             # prefix tokens served from the cache
    cache_hit: Optional[Any] = None    # pending CacheHit (prepare_hit takes it)
    swap: Optional[Any] = None         # pending SwapHandle (swap-in takes it)

    @property
    def n_context(self) -> int:
        return len(self.prompt) + len(self.tokens)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new

    @property
    def last_token(self) -> int:
        return self.tokens[-1] if self.tokens else self.prompt[-1]

    def prefill_tokens(self) -> List[int]:
        """Prompt plus anything generated before a preemption."""
        return self.prompt + self.tokens


@dataclasses.dataclass
class StepPlan:
    """Requests admitted this step, and running requests eligible for a
    decode token: not mid-prefill, and not newly admitted unless swapped
    in with a whole context."""

    admitted: List[Request]
    decode: List[Request]


class Scheduler:
    """Admission control + preemption over one ``PagedKVPool``."""

    def __init__(self, pool: PagedKVPool, cfg: ServingConfig,
                 cache: Optional[Any] = None, tiers: Optional[Any] = None):
        self.pool = pool
        self.cfg = cfg
        self.cache = cache                 # optional PrefixCache
        self.tiers = tiers                 # optional TierManager
        self.waiting: collections.deque = collections.deque()
        self.running: List[Request] = []
        self._free_slots = list(range(cfg.max_batch - 1, -1, -1))
        self.n_preemptions = 0
        self.n_swap_preemptions = 0

    def add(self, req: Request) -> None:
        if len(req.prompt) + req.max_new > self.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt+max_new "
                f"{len(req.prompt) + req.max_new} exceeds max_seq "
                f"{self.cfg.max_seq}"
            )
        self.waiting.append(req)

    def _run(self, req: Request, pages: List[int]) -> None:
        self.waiting.popleft()
        req.pages = pages
        req.slot = self._free_slots.pop()
        req.state = RequestState.RUNNING
        self.running.append(req)

    def admit(self) -> List[Request]:
        """Admit waiting requests while a decode slot AND the pages for their
        full (re-)prefill context are free; FIFO, no head-of-line bypass.

        A swapped-out request re-admits onto fresh pages, with no cache
        lookup.  Otherwise the cache's longest matched prefix is shared (its
        full pages, plus a guard reference on a partial tail's page, the
        copy-on-write source), BEFORE allocation, whose cache eviction must
        not reclaim them; only the rest is allocated."""
        admitted = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            if req.swap is not None:
                pages = self._alloc(req.swap.n_pages)
                if pages is None:
                    break
                self._run(req, pages)
                admitted.append(req)
                continue
            hit = (self.cache.lookup(req.prefill_tokens())
                   if self.cache is not None else None)
            shared = [e.page for e in hit.full] if hit is not None else []
            guard = ([hit.partial.page]
                     if hit is not None and hit.partial is not None else [])
            self.pool.share(shared + guard)
            pages = self._alloc(
                self.cfg.pages_for(max(req.n_context, 1)) - len(shared))
            if pages is None:
                self.pool.free(shared + guard)
                break
            self._run(req, shared + pages)
            req.cached_tokens = hit.n_tokens if hit is not None else 0
            req.cache_hit = hit
            req.pos = 0
            admitted.append(req)
            if self.cache is not None:
                self.cache.note_admit(hit)
        return admitted

    def step_plan(self, prefilling: List[Request]) -> StepPlan:
        """Admit, then split the step's work: requests streaming prompt
        chunks, and admissions that owe a prefill, hold their slot but do
        not decode until their last chunk.  A swapped-in request with a
        whole context (``prefill_pos is None``) decodes this very step."""
        admitted = self.admit()
        busy = {id(r) for r in prefilling}
        busy |= {id(r) for r in admitted
                 if r.swap is None or r.prefill_pos is not None}
        decode = [
            r for r in self.running
            if id(r) not in busy and r.state is RequestState.RUNNING
        ]
        return StepPlan(admitted=admitted, decode=decode)

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Allocation that evicts LRU cache-only pages before it fails."""
        pages = self.pool.alloc(n)
        if pages is None and self.cache is not None:
            if self.cache.evict(n - self.pool.n_free) > 0:
                pages = self.pool.alloc(n)
        return pages

    def finish(self, req: Request) -> None:
        self.pool.free(req.pages)
        req.pages = []
        self._free_slots.append(req.slot)
        req.slot = None
        req.state = RequestState.FINISHED
        self.running.remove(req)

    def ensure_capacity(self, req: Request) -> bool:
        """Grow ``req``'s block table to cover position ``req.pos``,
        preempting newer requests under page pressure.  False when no victim
        exists (the request skips this step)."""
        assert req.state is RequestState.RUNNING, req
        while self.cfg.pages_for(req.pos + 1) > len(req.pages):
            got = self._alloc(1)
            if got is not None:
                req.pages.extend(got)
                continue
            victim = self._pick_victim(req)
            if victim is None:
                return False
            self.preempt(victim)
        return True

    def _pick_victim(self, needy: Request) -> Optional[Request]:
        if self.running and self.running[-1] is not needy:
            return self.running[-1]
        return None

    def preempt(self, req: Request) -> None:
        """Evict ``req`` under page pressure.  With a tier manager and
        ``swap_policy="swap"`` its pages are swapped out (boundary-scrubbed
        host copies) and it keeps its position, mid-prefill included;
        otherwise, or when the host store is full, recompute: drop the
        pages, keep the tokens.  Either way only this request's references
        are released, and it rejoins the head of the waiting queue."""
        assert req.cache_hit is None, "preempting an unprepared cache hit"
        assert req.swap is None, "preempting a request not yet swapped in"
        handle = None
        if self.tiers is not None and self.cfg.swap_policy == "swap":
            handle = self.tiers.swap_out(req.pages)
        self.pool.free(req.pages)
        req.pages = []
        if handle is not None:
            req.swap = handle
            self.n_swap_preemptions += 1
        else:
            req.pos = 0
            req.cached_tokens = 0
            req.prefill_pos = None
        self._free_slots.append(req.slot)
        req.slot = None
        req.state = RequestState.WAITING
        req.n_preempted += 1
        self.running.remove(req)
        self.waiting.appendleft(req)
        self.n_preemptions += 1

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
