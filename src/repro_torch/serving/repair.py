"""Page-granular reactive repair + the background sweep.

  reactive   the paged kernels are the trap: they emit per-page fatal
             counts as they read, so ``repair_counts`` scrubs exactly the
             pages that faulted, with no separate detection pass; the
             gathered-view fallback probes its pages first instead
             (``repair_step``)
  routed     kernel counter vectors reported through ``note_kernel`` fold
             into the unified stats and mark the step's pages dirty
  sweep      every ``sweep_interval`` steps a rotating window of
             ``sweep_pages`` pages is scrubbed, catching flips in cold pages
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Set

import numpy as np

from ..core import stats as stats_lib
from ..runtime import ApproxSpace, ScrubSchedule, serving_scope
from .config import ServingConfig
from .pool import PagedKVPool


class PageRepairManager:
    """Owns the dirty set, the sweep cursor and the repair-mode dispatch."""

    def __init__(self, pool: PagedKVPool, space: ApproxSpace,
                 cfg: ServingConfig,
                 on_host_sync: Optional[Callable[[], None]] = None):
        self.pool = pool
        self.space = space
        self.cfg = cfg
        self.sweep = ScrubSchedule(boundary=False, interval=cfg.sweep_interval)
        self._dirty: Set[int] = set()
        self._sweep_cursor = 0
        self.n_reactive_scrubs = 0
        self.n_sweep_scrubs = 0
        # every blocking device read this manager forces reports here
        self._on_host_sync = on_host_sync or (lambda: None)

    def note_kernel(self, counts, touched: Iterable[int]) -> None:
        """Fold a kernel counter vector into the stats and route its events
        back to the live pages the reporting step touched."""
        self.space.record_kernel(counts)
        events = int(counts[stats_lib.EV_TOTAL])
        if events > 0:
            pages = [
                p for p in touched
                if p <= self.pool.null_page and not self.pool.is_free(p)
            ]
            self._dirty.update(pages)
            self.pool.attribute(pages, events)

    def mark_dirty(self, pages: Iterable[int]) -> None:
        self._dirty.update(pages)

    def repair_step(self, touched: Sequence[int],
                    stats: stats_lib.Stats) -> stats_lib.Stats:
        """The gathered-view fallback's reactive pass, before the step's
        compute reads the touched pages: probe touched ∪ dirty ∪ {null},
        then scrub what holds a fatal lane."""
        scope = serving_scope(self.cfg.repair)
        if scope == "none":
            return stats
        candidates = set(touched) | self._dirty | {self.pool.null_page}
        self._on_host_sync()          # the probe blocks on a device read
        faulty = self.pool._probe_fatal_pages(candidates)
        return self._scrub_faulty(scope, faulty, stats)

    def repair_counts(self, page_counts, covered: Sequence[int],
                      stats: stats_lib.Stats,
                      defer: Optional[List] = None) -> stats_lib.Stats:
        """Reactive repair driven by the kernels' per-page fatal counts
        (``(n_pages + 1,)``, host).  Dirty pages outside this step's
        coverage keep the probe.  A fault in the slot this step's K/V write
        overwrites is healed by the write before any read: never counted.
        ``defer`` is the desynchronized engine's attribution queue: the
        scrub's event delta is appended as ``(faulty pages, delta)`` for the
        next drain to charge, so this pass adds no host read of its own."""
        scope = serving_scope(self.cfg.repair)
        if scope == "none":
            return stats
        counts = np.asarray(page_counts)
        faulty = [int(p) for p in np.nonzero(counts > 0)[0]]
        stale = self._dirty - set(covered)
        if stale:
            self._on_host_sync()
            faulty = sorted(set(faulty) | set(self.pool._probe_fatal_pages(stale)))
        return self._scrub_faulty(scope, faulty, stats, defer=defer)

    def _scrub_faulty(self, scope: str, faulty: Sequence[int],
                      stats: stats_lib.Stats,
                      defer: Optional[List] = None) -> stats_lib.Stats:
        """Scrub faulty ∪ dirty, clear the dirty set, charge the events to
        the pages that held a fatal lane (now, or through ``defer``)."""
        scrub_set = sorted(set(faulty) | self._dirty)
        self._dirty.clear()
        if not scrub_set:
            return stats
        if defer is None:
            self._on_host_sync()
        events0 = stats["events"]
        stats = self.pool.scrub_scope(scope, scrub_set, stats, trigger="reactive")
        self.n_reactive_scrubs += 1
        if defer is not None:
            defer.append((list(faulty), stats["events"] - events0))
            return stats
        self._on_host_sync()
        delta = stats["events"] - events0
        if delta > 0:
            self.pool.attribute(faulty, delta)
        return stats

    def sweep_step(self, t: int, stats: stats_lib.Stats) -> stats_lib.Stats:
        """Background sweep tick (page mode: a rotating window; whole mode:
        the whole pool)."""
        scope = serving_scope(self.cfg.repair)
        if scope == "none" or not self.sweep.due(t):
            return stats
        if scope == "tree":
            self.n_sweep_scrubs += 1
            return self.pool.scrub_scope(scope, (), stats, trigger="interval")
        n = self.pool.cfg.n_pages
        window: List[int] = [
            (self._sweep_cursor + i) % n for i in range(min(self.cfg.sweep_pages, n))
        ]
        self._sweep_cursor = (self._sweep_cursor + len(window)) % n
        self.n_sweep_scrubs += 1
        return self.pool.scrub_scope(scope, window, stats, trigger="interval")

    def summary(self) -> dict:
        return {
            "reactive_scrubs": self.n_reactive_scrubs,
            "sweep_scrubs": self.n_sweep_scrubs,
            "scrub_calls": self.pool.scrub_calls,
            "scrubbed_bytes": self.pool.scrubbed_bytes,
            "hot_pages": int(np.count_nonzero(self.pool.page_events)),
        }
