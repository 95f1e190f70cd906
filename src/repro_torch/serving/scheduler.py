"""Continuous-batching scheduler: admit -> prefill -> decode -> finish/evict.

A FIFO waiting queue, admission control against free pages, per-step page
growth for running requests, and recompute-style preemption under page
pressure: the victim (always the newest running request, and only if newer
than the one that needs the page) frees its pages and rejoins the head of
the queue with its generated tokens folded into its prefill prompt.  Pure
host-side bookkeeping; the device work lives in the engine.  The prefix
cache and the host tier of the reference are not ported.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import List, Optional

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
    decode token (not newly admitted, not mid-prefill)."""

    admitted: List[Request]
    decode: List[Request]


class Scheduler:
    """Admission control + preemption over one ``PagedKVPool``."""

    def __init__(self, pool: PagedKVPool, cfg: ServingConfig):
        self.pool = pool
        self.cfg = cfg
        self.waiting: collections.deque = collections.deque()
        self.running: List[Request] = []
        self._free_slots = list(range(cfg.max_batch - 1, -1, -1))
        self.n_preemptions = 0

    def add(self, req: Request) -> None:
        if len(req.prompt) + req.max_new > self.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt+max_new "
                f"{len(req.prompt) + req.max_new} exceeds max_seq "
                f"{self.cfg.max_seq}"
            )
        self.waiting.append(req)

    def admit(self) -> List[Request]:
        """Admit waiting requests while a decode slot AND the pages for their
        full (re-)prefill context are free; FIFO, no head-of-line bypass."""
        admitted = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            pages = self.pool.alloc(self.cfg.pages_for(max(req.n_context, 1)))
            if pages is None:
                break
            self.waiting.popleft()
            req.pages = pages
            req.pos = 0
            req.slot = self._free_slots.pop()
            req.state = RequestState.RUNNING
            self.running.append(req)
            admitted.append(req)
        return admitted

    def step_plan(self, prefilling: List[Request]) -> StepPlan:
        """Admit, then split the step's work: requests streaming prompt
        chunks hold their slot but do not decode until their last chunk."""
        admitted = self.admit()
        busy = {id(r) for r in prefilling} | {id(r) for r in admitted}
        decode = [
            r for r in self.running
            if id(r) not in busy and r.state is RequestState.RUNNING
        ]
        return StepPlan(admitted=admitted, decode=decode)

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
            got = self.pool.alloc(1)
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
        """Recompute-style eviction: drop the pages, keep the tokens, rejoin
        the head of the waiting queue."""
        self.pool.free(req.pages)
        req.pages = []
        req.pos = 0
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
