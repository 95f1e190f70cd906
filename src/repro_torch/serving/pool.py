"""Paged KV pool: block-table-indexed physical cache pages + the free list.

Every leaf is ``(n_pages + 1, L, page_size, Kh, Dh)`` with the page axis
leading, so one page is one contiguous row — the unit of region accounting,
fault attribution and targeted repair.  Row ``n_pages`` is the null page
that pads block tables; it is read, repaired and counted like any page.
The pool's state is the flat dict ``tree = {"layers/k": ..., "layers/v":
...}``, updated in place by the model's K/V writes and by the scrubs.

The paged kernels read the pool straight through block tables.  The
gathered-view fallback copies a batch of block tables out as the model's
dense cache (``gather``) and writes it back (``scatter``); both are counted
(``n_gathers``, ``n_scatters``), so tests can tell the paths apart.

Pages are refcounted: ``alloc`` hands a page out with one reference,
``share`` adds a holder (the prefix cache, a request admitted onto a cached
prefix), ``free`` drops one and returns the page to the free list at zero.
The dwell clock (``now - page_clean_step``) is what the prefix cache charges
before it re-shares a page.  ``pages_view`` and ``snapshot_page`` are host
copies (blocking copies off the card), so recycling the device page later
never changes them; ``write_pages`` puts such rows back into live pages.
"""
from __future__ import annotations

import collections
import warnings
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .. import device as device_lib
from ..core import stats as stats_lib
from ..core.regions import Region
from ..runtime import ApproxSpace
from .config import ServingConfig


class PagedKVPool:
    """Fixed-size KV pages + free list + per-page fault accounting."""

    def __init__(self, model: Any, space: ApproxSpace, cfg: ServingConfig, *,
                 device=None):
        dev = device_lib.resolve(device)
        defs = model.paged_cache_defs(cfg.n_pages + 1, cfg.page_size)
        self.tree = {
            path: torch.zeros(shape, dtype=dtype, device=dev)
            for path, (shape, dtype) in sorted(defs.items())
        }
        self.device = dev
        self.space = space
        self.cfg = cfg
        self.null_page = cfg.n_pages
        space.regions_for(self.tree)        # pre-register page regions
        self._free: collections.deque = collections.deque(range(cfg.n_pages))
        self._refcount = np.zeros(cfg.n_pages + 1, np.int64)
        self._refcount[self.null_page] = 1
        # dwell clock: ``now`` is the engine's step; page_clean_step stamps
        # each page's last scrub or zeroing
        self.now = 0
        self.page_clean_step = np.zeros(cfg.n_pages + 1, np.int64)
        self.page_events = np.zeros(cfg.n_pages + 1, np.int64)
        self.page_scrubs = np.zeros(cfg.n_pages + 1, np.int64)
        self.scrubbed_bytes = 0
        self.scrub_calls = 0
        self.n_gathers = 0
        self.n_scatters = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def total_bytes(self) -> int:
        """Bytes of the whole pool's float leaves."""
        return sum(leaf.numel() * leaf.element_size()
                   for leaf in self.tree.values() if leaf.is_floating_point())

    @property
    def page_bytes(self) -> int:
        return self.total_bytes // (self.cfg.n_pages + 1)

    def _check_page(self, p: int) -> None:
        if not 0 <= p < self.null_page:
            raise ValueError(f"bad page id {p}")

    # ------------------------------------------------------------ allocation
    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` zeroed pages, or None when the pool cannot."""
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        if pages:
            idx = torch.as_tensor(pages, device=self.device)
            for leaf in self.tree.values():
                if leaf.is_floating_point():
                    leaf[idx] = 0
            assert all(self._refcount[p] == 0 for p in pages), pages
            self._refcount[pages] = 1
            self.page_clean_step[pages] = self.now
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one reference to each page (a new holder).  Sharing a free
        page raises."""
        for p in pages:
            self._check_page(p)
            if self._refcount[p] <= 0:
                raise RuntimeError(f"sharing free page {p}")
            self._refcount[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Release one reference per page; a page returns to the free list
        when its last holder lets go.  A double free raises."""
        for p in pages:
            self._check_page(p)
            if self._refcount[p] <= 0:
                raise RuntimeError(f"double free of page {p} (no live reference)")
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(p)

    def refcount(self, page: int) -> int:
        return int(self._refcount[page])

    def is_free(self, page: int) -> bool:
        return self._refcount[page] == 0

    def dwell(self, page: int) -> int:
        """Engine steps (injection windows) since ``page`` was last known
        clean."""
        return int(self.now - self.page_clean_step[page])

    def mark_clean(self, pages: Sequence[int]) -> None:
        self.page_clean_step[sorted(set(pages))] = self.now

    def copy_page(self, src: int, dst: int) -> None:
        """Copy page ``src``'s rows into ``dst`` on the device (the prefix
        cache's copy-on-write fork); the clone inherits ``src``'s dwell
        stamp."""
        for leaf in self.tree.values():
            if leaf.is_floating_point():
                leaf[dst] = leaf[src]
        self.page_clean_step[dst] = self.page_clean_step[src]

    def pages_view(self, pages: Sequence[int]) -> dict:
        """Host copies of several pages' rows, ``{path: (n, L, pg, Kh,
        Dh)}`` in ``pages`` order.  The copy off the card blocks until the
        rows have arrived, so a later ``free``/``alloc`` of the device pages
        cannot change it."""
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=self.device)
        return {
            path: leaf.index_select(0, idx).cpu()
            for path, leaf in self.tree.items() if leaf.is_floating_point()
        }

    def snapshot_page(self, page: int) -> dict:
        """Host copy of one page's rows (leading axis 1): the prefix cache's
        reference for reference repair."""
        return self.pages_view([page])

    def write_pages(self, pages: Sequence[int], views: dict) -> None:
        """Write page rows (leading axis in ``pages`` order) into live pool
        pages, the tier's swap-in.  Writing into a free page raises."""
        pages = list(pages)
        for p in pages:
            self._check_page(p)
            if self._refcount[p] <= 0:
                raise RuntimeError(f"writing into free page {p}")
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for path, leaf in self.tree.items():
            if leaf.is_floating_point():
                leaf[idx] = views[path].to(device=self.device, dtype=leaf.dtype)

    def block_table(self, pages: Sequence[int]) -> np.ndarray:
        """Fixed-width block table row, null-padded."""
        M = self.cfg.max_pages_per_request
        assert len(pages) <= M, "request outgrew its block table"
        row = np.full((M,), self.null_page, np.int32)
        row[: len(pages)] = pages
        return row

    # --------------------------------------------------------- gather/scatter
    def gather(self, block_tables) -> dict:
        """Pool pages -> per-request dense cache views: each leaf (P, L, pg,
        Kh, Dh) through block tables (R, M) gives (L, R, M * pg, Kh, Dh),
        the model's ``cache_defs`` layout."""
        self.n_gathers += 1
        bt = torch.as_tensor(np.asarray(block_tables), device=self.device).long()
        out = {}
        for path, leaf in self.tree.items():
            v = leaf[bt].movedim(2, 0)                 # (L, R, M, pg, ...)
            out[path] = v.reshape(v.shape[0], v.shape[1], -1, *v.shape[4:])
        return out

    def scatter(self, view: dict, block_tables) -> None:
        """Write per-request cache views back into the pool pages.  A page
        named more than once (the null page padding block tables) takes its
        last occurrence, row-major over ``block_tables``: one write per
        page, so the result does not depend on the device's write order."""
        self.n_scatters += 1
        flat = np.asarray(block_tables).reshape(-1)
        pages, first_rev = np.unique(flat[::-1], return_index=True)
        last = flat.size - 1 - first_rev
        dev = self.device
        pages_t = torch.as_tensor(pages, device=dev).long()
        last_t = torch.as_tensor(last, device=dev).long()
        for path, leaf in self.tree.items():
            pg = leaf.shape[2]
            v = view[path]
            L, R = v.shape[:2]
            v = v.reshape(L, R, -1, pg, *v.shape[3:]).movedim(0, 2)
            v = v.reshape(-1, *v.shape[2:])            # (R * M, L, pg, ...)
            leaf[pages_t] = v[last_t].to(leaf.dtype)

    # ----------------------------------------------------------------- repair
    def fatal_pages(self, page_ids: Sequence[int]) -> List[int]:
        """Deprecated public probe: the paged kernels emit per-page fatal
        counts as they read, so reactive detection needs no separate scan;
        the probe remains for the gathered-view fallback, through
        ``PageRepairManager.repair_step``."""
        warnings.warn(
            "PagedKVPool.fatal_pages is deprecated: the paged kernels emit "
            "per-page fatal counts on read (PageRepairManager.repair_counts);"
            " the probe remains only for gathered-view fallback paths",
            DeprecationWarning,
            stacklevel=2,
        )
        return self._probe_fatal_pages(page_ids)

    def _probe_fatal_pages(self, page_ids: Sequence[int]) -> List[int]:
        """The subset of ``page_ids`` holding ≥1 fatal lane under each
        leaf's rule detector (detection only), gated like the repair:
        approximate-region float leaves whose rule fires reactively."""
        ids = sorted(set(page_ids))
        if not ids:
            return []
        idx = torch.as_tensor(ids, device=self.device)
        regions = self.space.regions_for(self.tree)
        rules, _ = self.space.rules_for(self.tree)
        flags = None
        for path, leaf in self.tree.items():
            if not leaf.is_floating_point() or regions[path] is not Region.APPROX:
                continue
            if not rules[path].fires("reactive"):
                continue
            rows = leaf[idx]
            nan_m, inf_m = rules[path].detect.masks(rows)
            bad = (nan_m | inf_m).reshape(rows.shape[0], -1).any(dim=1)
            flags = bad if flags is None else flags | bad
        if flags is None:
            return []
        return [p for p, b in zip(ids, flags.cpu().tolist()) if b]

    def scrub_pages(self, page_ids: Sequence[int], stats: stats_lib.Stats, *,
                    trigger: str = "reactive") -> stats_lib.Stats:
        """Targeted in-place scrub of exactly ``page_ids`` with byte
        accounting — the page-granular reactive repair."""
        ids = sorted(set(page_ids))
        if not ids:
            return stats
        plan = self.space.plan_for(self.tree, scope="pages", trigger=trigger)
        if plan.scope == "none" or plan.page_row_bytes == 0:
            return stats
        self.tree, stats = self.space.scrub_pages(
            self.tree, ids, stats, trigger=trigger
        )
        self.page_scrubs[ids] += 1
        self.scrubbed_bytes += len(ids) * plan.page_row_bytes
        self.scrub_calls += 1
        self.mark_clean(ids)
        return stats

    def scrub_all(self, stats: stats_lib.Stats, *,
                  trigger: str = "reactive") -> stats_lib.Stats:
        """Whole-pool in-place scrub (the ``repair="whole"`` baseline)."""
        plan = self.space.plan_for(self.tree, scope="tree", trigger=trigger)
        if plan.scope == "none" or plan.bytes_per_run == 0:
            return stats
        self.tree, stats = self.space.scrub(self.tree, stats, trigger=trigger)
        self.page_scrubs += 1
        self.scrubbed_bytes += plan.bytes_per_run
        self.scrub_calls += 1
        self.mark_clean(range(self.cfg.n_pages + 1))
        return stats

    def scrub_scope(self, scope: str, page_ids: Sequence[int],
                    stats: stats_lib.Stats, *,
                    trigger: str = "reactive") -> stats_lib.Stats:
        """Run one planned repair pass by plan scope."""
        if scope == "pages":
            return self.scrub_pages(page_ids, stats, trigger=trigger)
        if scope == "tree":
            return self.scrub_all(stats, trigger=trigger)
        assert scope == "none", f"bad plan scope {scope!r}"
        return stats

    def reference_repair_page(self, page: int, snapshot: dict,
                              stats: stats_lib.Stats) -> stats_lib.Stats:
        """Repair one page against its host snapshot: fatal lanes take the
        exact bits the page held when it was cached.  Charged like a page
        scrub (one page row's bytes), and the page is stamped clean."""
        idx = torch.as_tensor([page], dtype=torch.long, device=self.device)
        view = {path: leaf.index_select(0, idx) for path, leaf in self.tree.items()}
        plan = self.space.plan_for(view, scope="reference")
        if plan.bytes_per_run == 0:
            return stats
        view, stats = self.space.scrub_with_reference(view, snapshot, stats)
        for path, leaf in self.tree.items():
            leaf[idx] = view[path]
        self.page_scrubs[page] += 1
        self.scrubbed_bytes += plan.bytes_per_run
        self.scrub_calls += 1
        self.mark_clean([page])
        return stats

    def attribute(self, page_ids: Sequence[int], n_events: int) -> None:
        """Charge ``n_events`` repair events to the pages a step touched."""
        if n_events and len(page_ids):
            ids = sorted(set(page_ids))
            self.page_events[ids] += n_events
