"""Tiered KV: a host-memory exact page tier with repair at the boundary.

The device pool dwells under relaxed refresh (approximate); the host store
does not (exact).  So every device→host crossing is a repair boundary:

  swap-out   one detector scrub over the leaving pages (a page-scoped plan
             with ``trigger="boundary"``: the scrub kernel on the card),
             then the host copy.  The host tier never holds a fatal lane.
  swap-in    a trusted write into freshly allocated device pages and a
             re-stamp of ``page_clean_step``: the dwell clock restarts from
             a known-clean state.  No detector runs.

Two producers use the tier: ``Scheduler.preempt`` swaps its victim out
instead of dropping its pages (recompute stays the fallback when the store
is full), and ``PrefixCache`` eviction demotes cold entries before it drops
them, to promote them back on a later hit.

``HostPageStore`` keeps one page row per slot in the pool's leaf layout, in
pinned CPU tensors when the pool is on the card and plain CPU tensors when
it is on the CPU, with a free list: a double free and a read of a freed
slot raise.  It stores copies (``PagedKVPool.pages_view``), so recycling
the device page afterwards cannot change them.

Every boundary scrub is charged to ``ApproxSpace.scrubbed_bytes`` (inside
``PagedKVPool.scrub_pages``) and to ``TierManager.boundary_scrub_bytes``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..core import stats as stats_lib
from ..runtime import ApproxSpace
from ..runtime.plan import serving_scope
from .config import ServingConfig
from .pool import PagedKVPool

__all__ = ["HostPageStore", "SwapHandle", "TierManager"]


class HostPageStore:
    """Fixed-capacity host page buffer: the exact tier.  One buffer per
    float pool leaf, ``(n_pages, *row)``; ``put``/``get`` trees are
    ``PagedKVPool.pages_view``/``write_pages`` trees."""

    def __init__(self, pool_tree: Dict[str, torch.Tensor], n_pages: int):
        self.n_pages = int(n_pages)
        self._buffers = {
            path: torch.zeros(
                (self.n_pages,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                pin_memory=leaf.device.type == "cuda",
            )
            for path, leaf in pool_tree.items() if leaf.is_floating_point()
        }
        self._free: collections.deque = collections.deque(range(self.n_pages))
        self._live = [False] * self.n_pages
        self.puts = 0
        self.gets = 0
        self.peak_used = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    def put(self, views: Dict[str, torch.Tensor], n: int) -> List[int]:
        """Store ``n`` page rows (the leading axis of each leaf of
        ``views``) in ``n`` free slots; returns the slots in row order.
        Raises when the store cannot hold them: the caller decides the
        fallback, the store never drops a page."""
        if n > len(self._free):
            raise RuntimeError(
                f"host store full ({self.n_used}/{self.n_pages} used, need {n})"
            )
        slots = [self._free.popleft() for _ in range(n)]
        idx = torch.as_tensor(slots, dtype=torch.long)
        for path, buf in self._buffers.items():
            buf[idx] = views[path].to(device="cpu", dtype=buf.dtype)
        for s in slots:
            self._live[s] = True
        self.puts += n
        self.peak_used = max(self.peak_used, self.n_used)
        return slots

    def get(self, slots: Sequence[int]) -> Dict[str, torch.Tensor]:
        """The stored rows of ``slots`` (leading axis ``len(slots)``), as
        copies that stay valid after the slots are freed and reused."""
        slots = list(slots)
        if not all(self._live[s] for s in slots):
            raise RuntimeError(f"reading freed host slot(s) in {slots}")
        idx = torch.as_tensor(slots, dtype=torch.long)
        self.gets += len(slots)
        return {path: buf.index_select(0, idx)
                for path, buf in self._buffers.items()}

    def free(self, slots: Sequence[int]) -> None:
        """Release slots to the free list; a double free raises."""
        for s in slots:
            if not 0 <= s < self.n_pages:
                raise ValueError(f"bad host slot {s}")
            if not self._live[s]:
                raise RuntimeError(f"double free of host slot {s}")
            self._live[s] = False
            self._free.append(s)


@dataclasses.dataclass
class SwapHandle:
    """A preempted request's context in the exact tier: host slots in
    block-table order, consumed once by ``swap_in``."""

    slots: List[int]

    @property
    def n_pages(self) -> int:
        return len(self.slots)


class TierManager:
    """Every crossing between the device pool and the host store goes
    through here, so the boundary scrub and its byte ledger cannot be
    bypassed."""

    def __init__(self, pool: PagedKVPool, space: ApproxSpace,
                 cfg: ServingConfig):
        self.pool = pool
        self.space = space
        self.cfg = cfg
        self.host = HostPageStore(pool.tree, cfg.host_pages)
        self.boundary_scrub_bytes = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.swapped_pages_out = 0
        self.swapped_pages_in = 0
        self.recompute_fallbacks = 0
        self.demotions = 0
        self.promotions = 0

    def _boundary_scrub(self, pages: Sequence[int]) -> None:
        """One page-scoped pass over ``pages`` before they cross to the
        host, tagged ``"boundary"``; none with ``repair="off"`` (the no-repair
        arm repairs nowhere).  Its stats go to the space's stream."""
        if serving_scope(self.cfg.repair) == "none":
            return
        before = self.pool.scrubbed_bytes
        delta = self.pool.scrub_pages(pages, stats_lib.zeros(), trigger="boundary")
        self.space.record(delta)
        self.boundary_scrub_bytes += self.pool.scrubbed_bytes - before

    def swap_out(self, pages: Sequence[int]) -> Optional[SwapHandle]:
        """Scrub, then copy ``pages`` to the host tier.  ``None`` (counted
        as a recompute fallback) when the store cannot hold them.  The
        device pages stay the caller's to free."""
        pages = list(pages)
        if not pages or len(pages) > self.host.n_free:
            self.recompute_fallbacks += 1
            return None
        self._boundary_scrub(pages)
        slots = self.host.put(self.pool.pages_view(pages), len(pages))
        self.swap_outs += 1
        self.swapped_pages_out += len(pages)
        return SwapHandle(slots=slots)

    def swap_in(self, handle: SwapHandle, pages: Sequence[int]) -> None:
        """Write a parked context into freshly allocated ``pages``, re-stamp
        their dwell clock and release the host slots.  No detector runs."""
        pages = list(pages)
        assert len(pages) == handle.n_pages, (pages, handle)
        self.pool.write_pages(pages, self.host.get(handle.slots))
        self.pool.mark_clean(pages)
        self.host.free(handle.slots)
        self.swap_ins += 1
        self.swapped_pages_in += len(pages)

    def demote_page(self, page: int) -> Optional[int]:
        """Park one cold cache page (boundary scrub, then copy).  Returns
        its slot, or ``None`` when the store is full."""
        if self.host.n_free < 1:
            return None
        self._boundary_scrub([page])
        slot = self.host.put(self.pool.pages_view([page]), 1)[0]
        self.demotions += 1
        return slot

    def stash_views(self, views: Dict[str, torch.Tensor]) -> Optional[int]:
        """Park one page row that is already exact (a full entry's insert
        snapshot), with no boundary scrub.  ``None`` when the store is
        full."""
        if self.host.n_free < 1:
            return None
        slot = self.host.put(views, 1)[0]
        self.demotions += 1
        return slot

    def promote_page(self, slot: int) -> Optional[int]:
        """Bring one parked page back through the normal allocation.
        Returns the device page (refcount 1, dwell re-stamped), or ``None``
        when the pool is full and the page stays parked."""
        pages = self.pool.alloc(1)
        if pages is None:
            return None
        self.pool.write_pages(pages, self.host.get([slot]))
        self.pool.mark_clean(pages)
        self.host.free([slot])
        self.promotions += 1
        return pages[0]

    def slot_views(self, slot: int) -> Dict[str, torch.Tensor]:
        """The stored row of one slot: a promoted full entry's snapshot."""
        return self.host.get([slot])

    def drop_slot(self, slot: int) -> None:
        """Discard a parked page (its cache entry was superseded)."""
        self.host.free([slot])

    def stats(self) -> Dict[str, int]:
        return {
            "host_pages": self.host.n_pages,
            "host_used": self.host.n_used,
            "host_peak_used": self.host.peak_used,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "swapped_pages_out": self.swapped_pages_out,
            "swapped_pages_in": self.swapped_pages_in,
            "boundary_scrub_bytes": self.boundary_scrub_bytes,
            "recompute_fallbacks": self.recompute_fallbacks,
            "demotions": self.demotions,
            "promotions": self.promotions,
        }
