"""Repair-aware prefix cache: refcounted copy-on-write KV pages with a
dwell-gated scrub on reuse.

Finished prefixes stay resident: exact token tuples key one entry per page
(a chain of full-page entries, then at most one partial tail), so a new
request admits onto the longest cached prefix and prefills only its suffix.

Each engine step is one injection window, so a cached page's expected
fault count grows with its dwell (``ApproxConfig.expected_faults``).  On a
hit, the scrub on reuse runs only for pages whose estimate crosses
``ServingConfig.dwell_threshold`` (``<= 0``: every hit), with the strongest
repair each entry has:

  * a full-page entry holds a host snapshot taken at insert; its fatal
    lanes take the snapshot's exact bits (``reference_repair_page``);
  * a partial tail keeps changing after insert (its owner appends rows),
    so it is detector-scrubbed (``scrub_pages``, the scrub kernel on the
    card).

Sharing discipline (host bookkeeping; the device work is the engine's):

  refcounts   every cached page holds one pool reference of the cache's
              own, plus one per running request sharing it; finish and
              preemption release the request's only, and a double free
              raises
  CoW forks   a request diverging inside a cached partial page never writes
              the shared copy: ``prepare_hit`` clones it into the request's
              first private page, and the suffix prefill overwrites the
              clone from the match on; full pages need no clone
  LRU         eviction (allocation pressure, ``max_cached_pages``) takes
              only leaf entries that no request shares, so a cached prefix
              is always a contiguous page run
  fragments   each interior prefix of a partial tail points at its owner,
              so a request diverging inside an already-forked page forks
              again instead of re-prefilling the tail
  demotion    with a ``TierManager``, an evicted entry is parked in the
              host tier (a full entry's snapshot as it is, a partial tail
              through the boundary scrub); a later lookup promotes it back
              through the normal allocation, parents first
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..core import stats as stats_lib
from ..runtime import ApproxSpace
from .config import ServingConfig
from .pool import PagedKVPool

__all__ = ["PrefixCache", "CacheHit"]


@dataclasses.dataclass
class _Entry:
    """One cached page: the KV of one page-worth (or tail-fraction) of a
    token prefix.  ``key`` is the exact token tuple whose KV the page's
    valid rows hold; ``parent`` is the one-page-shorter chain predecessor."""

    key: Tuple[int, ...]
    page: int
    n_tokens: int
    partial: bool
    snapshot: Any                      # host page copy (full entries only)
    parent: Optional[Tuple[int, ...]]
    n_children: int = 0
    last_used: int = 0
    hits: int = 0


@dataclasses.dataclass
class _HostEntry:
    """One cache entry parked in the host tier: the slot holding its page
    row, plus enough metadata to rebuild the resident ``_Entry`` on
    promotion (the chain walk supplies the parent)."""

    key: Tuple[int, ...]
    slot: int
    n_tokens: int
    partial: bool


@dataclasses.dataclass
class CacheHit:
    """A lookup match: ``full`` is the chain of whole-page entries, then
    optionally one ``partial`` tail entry extending it inside a page.
    ``n_tokens`` counts every matched token (full pages + partial rows)."""

    n_tokens: int
    full: Tuple[_Entry, ...]
    partial: Optional[_Entry]


class PrefixCache:
    """Hash-of-token-prefix → page-run index over one ``PagedKVPool``."""

    def __init__(
        self,
        pool: PagedKVPool,
        space: ApproxSpace,
        cfg: ServingConfig,
        tiers: Optional[Any] = None,
    ):
        self.pool = pool
        self.space = space
        self.cfg = cfg
        self.tiers = tiers                        # optional TierManager
        self._entries: Dict[Tuple[int, ...], _Entry] = {}
        self._host_entries: Dict[Tuple[int, ...], _HostEntry] = {}
        # interior fragments of partial tails: token-prefix → owner entry
        # key.  A request diverging *inside* an already-forked page matches
        # the owner's shared rows through one of these and CoW-forks again
        # instead of re-prefilling the whole tail.  Real entries shadow
        # fragments (the resident index is always probed first).
        self._fragments: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
        self._clock = 0
        # observation counters (Engine.cache_stats)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserts = 0
        self.evictions = 0
        self.cow_forks = 0
        self.reuse_scrubs = 0          # detector scrub-on-reuse passes
        self.reuse_ref_repairs = 0     # snapshot reference repairs
        self.reuse_skips = 0           # hits below the dwell threshold
        self.fragment_hits = 0         # partial matched via an interior key
        self.demotions = 0             # evictions parked in the host tier
        self.promotions = 0            # host entries re-materialized on hit

    # ------------------------------------------------------------------ state
    @property
    def cached_pages(self) -> int:
        return len(self._entries)

    def _touch(self, e: _Entry) -> None:
        self._clock += 1
        e.last_used = self._clock

    # ----------------------------------------------------------------- lookup
    def lookup(self, tokens: List[int]) -> Optional[CacheHit]:
        """The longest cached prefix of ``tokens``, capped at
        ``len(tokens) - 1`` — at least one token must remain for the suffix
        prefill to consume (its logits produce the next token).  With a
        tier manager, a miss in the resident index falls through to the
        host tier: parked entries are *promoted* back (chain order, so a
        parent is always resident before its child) and count as hits."""
        toks = tuple(int(t) for t in tokens)
        cap = len(toks) - 1
        pg = self.cfg.page_size
        full: List[_Entry] = []
        k = 1
        while k * pg <= cap:
            key = toks[: k * pg]
            e = self._entries.get(key)
            if e is None:
                e = self._promote(key, k * pg, False, full)
            if e is None or e.partial:
                break
            full.append(e)
            k += 1
        # bounded tail probe: the longest partial entry extending the chain
        # inside the next page (≤ page_size - 1 dict probes).  A miss on
        # the exact key falls through to the fragment index: the owner's
        # page holds valid KV for its first n rows (KV at a row depends
        # only on the tokens up to it, which match), so the hit reuses the
        # owner's page and the suffix prefill overwrites from row n on.
        partial = None
        matched = 0
        lo = len(full) * pg
        for n in range(min(cap, lo + pg - 1), lo, -1):
            key = toks[:n]
            e = self._entries.get(key)
            if e is None:
                e = self._promote(key, n, True, full)
            if e is None:
                owner = self._fragments.get(key)
                if owner is not None:
                    e = self._entries.get(owner)
                    if e is not None and e.partial:
                        self.fragment_hits += 1
            if e is not None and e.partial:
                partial = e
                matched = n
                break
        if not full and partial is None:
            return None
        for e in full:
            self._touch(e)
            e.hits += 1
        if partial is not None:
            self._touch(partial)
            partial.hits += 1
        n_tokens = matched if partial is not None else lo
        return CacheHit(n_tokens=n_tokens, full=tuple(full), partial=partial)

    def _promote(
        self,
        key: Tuple[int, ...],
        n_tokens: int,
        want_partial: bool,
        chain: List[_Entry],
    ) -> Optional[_Entry]:
        """Re-materialize one parked host entry as a resident entry linked
        onto ``chain`` (the already-matched full-page run).  Returns None on
        a genuine miss, a full pool, or cache-capacity pressure — the host
        entry stays parked in the latter two cases."""
        if self.tiers is None:
            return None
        he = self._host_entries.get(key)
        if he is None or he.partial != want_partial:
            return None
        assert he.n_tokens == n_tokens, (he, n_tokens)
        if not self._make_room({e.key for e in chain} | {key}):
            return None
        # a full entry's parked bits ARE its insert-time snapshot — promote
        # them back as the reference for future scrub-on-reuse
        snapshot = None if he.partial else self.tiers.slot_views(he.slot)
        page = self.tiers.promote_page(he.slot)
        if page is None:
            return None
        del self._host_entries[key]
        parent = chain[-1] if chain else None
        e = _Entry(
            key=key,
            page=page,
            n_tokens=he.n_tokens,
            partial=he.partial,
            snapshot=snapshot,
            parent=parent.key if parent is not None else None,
        )
        if parent is not None:
            parent.n_children += 1
        self._entries[key] = e
        if e.partial:
            self._register_fragments(e)
        self._touch(e)
        self.promotions += 1
        return e

    # -------------------------------------------------- interior fragments
    def _fragment_keys(self, e: _Entry):
        lo = (e.n_tokens // self.cfg.page_size) * self.cfg.page_size
        return (e.key[:n] for n in range(lo + 1, e.n_tokens))

    def _register_fragments(self, e: _Entry) -> None:
        """Index every interior prefix of a partial tail.  Two partials
        sharing a fragment race; last insert wins (the loser's rows are a
        miss again — one extra prefill, never a wrong result)."""
        for key in self._fragment_keys(e):
            self._fragments[key] = e.key

    def _drop_fragments(self, e: _Entry) -> None:
        for key in self._fragment_keys(e):
            if self._fragments.get(key) == e.key:
                del self._fragments[key]

    def note_admit(self, hit: Optional[CacheHit]) -> None:
        """Count one successful admission against the hit/miss ledger (the
        scheduler calls this only when the request actually got its pages,
        so a full pool cannot inflate the miss rate)."""
        if hit is None:
            self.misses += 1
        else:
            self.hits += 1
            self.hit_tokens += hit.n_tokens

    # ------------------------------------------------------- scrub-on-reuse
    def _reuse_scrub(
        self, e: _Entry, stats: stats_lib.Stats
    ) -> stats_lib.Stats:
        """Dwell-gated scrub-on-reuse of one hit page: charge the page's
        dwell (steps since last scrub) to an expected-fault estimate; only
        a crossing estimate pays for repair before the page is re-read.
        ``dwell_threshold <= 0`` scrubs every hit (the always-scrub
        comparison arm)."""
        dwell = self.pool.dwell(e.page)
        est = self.space.config.expected_faults(
            self.pool.page_bytes, dwell, ber=self.cfg.ber
        )
        if self.cfg.dwell_threshold > 0 and est < self.cfg.dwell_threshold:
            self.reuse_skips += 1
            return stats
        if e.snapshot is not None:
            self.reuse_ref_repairs += 1
            return self.pool.reference_repair_page(e.page, e.snapshot, stats)
        self.reuse_scrubs += 1
        return self.pool.scrub_pages([e.page], stats, trigger="reactive")

    def prepare_hit(self, req: Any, stats: stats_lib.Stats) -> stats_lib.Stats:
        """Device work for one admitted cache hit, before its suffix
        prefill: scrub-on-reuse over the matched pages, then the
        copy-on-write fork of a partial tail (scrub the *source* first so
        the clone inherits clean bits and a fresh dwell stamp; the clone's
        rows past the match are overwritten by the suffix prefill).  Must
        run in the same engine phase as admission — the admit-time
        reference on the partial source is released here."""
        hit = req.cache_hit
        req.cache_hit = None
        if hit is None:
            return stats
        for e in hit.full:
            stats = self._reuse_scrub(e, stats)
        if hit.partial is not None:
            stats = self._reuse_scrub(hit.partial, stats)
            dst = req.pages[len(hit.full)]
            self.pool.copy_page(hit.partial.page, dst)
            self.cow_forks += 1
            self.pool.free([hit.partial.page])   # admit-time clone guard
        return stats

    # ----------------------------------------------------------------- insert
    def insert(self, req: Any) -> None:
        """Cache the request's just-prefilled prefix: one entry per fully
        written page (with a host snapshot — the checkpointed prefix for
        reference repair) plus one partial entry for a tail fraction.
        Existing entries are touched, not replaced (two same-prefix
        requests admitted in one batch race to insert; first wins).  The
        cache takes one pool reference per new entry.

        Only RESIDENT positions are cacheable: the prefill emitted one new
        token whose KV is written at the next decode step, so the key base
        stops at ``req.pos`` (the prefill context) — an entry must never
        promise a row the pool does not hold yet."""
        toks = tuple(int(t) for t in req.prefill_tokens())[: req.pos]
        if not toks:
            return
        pg = self.cfg.page_size
        n_full = len(toks) // pg
        protect = {toks[: k * pg] for k in range(1, n_full + 1)} | {toks}
        parent: Optional[_Entry] = None
        for k in range(1, n_full + 1):
            key = toks[: k * pg]
            e = self._entries.get(key)
            if e is None:
                e = self._insert_one(
                    key, req.pages[k - 1], k * pg, False, parent, protect
                )
                if e is None:
                    return
            else:
                self._touch(e)
            parent = e
        rem = len(toks) - n_full * pg
        if rem:
            e = self._entries.get(toks)
            if e is not None:
                self._touch(e)
            else:
                self._insert_one(
                    toks, req.pages[n_full], len(toks), True, parent, protect
                )

    def _insert_one(
        self,
        key: Tuple[int, ...],
        page: int,
        n_tokens: int,
        partial: bool,
        parent: Optional[_Entry],
        protect: set,
    ) -> Optional[_Entry]:
        if not self._make_room(protect):
            return None
        # a fresh resident insert supersedes any parked copy of the same
        # prefix — release its host slot instead of leaking it
        stale = self._host_entries.pop(key, None)
        if stale is not None:
            self.tiers.drop_slot(stale.slot)
        self.pool.share([page])
        e = _Entry(
            key=key,
            page=page,
            n_tokens=n_tokens,
            partial=partial,
            # a partial page's owner keeps appending rows, so it has no
            # stable reference — detector scrub handles it on reuse
            snapshot=None if partial else self.pool.snapshot_page(page),
            parent=parent.key if parent is not None else None,
        )
        if parent is not None:
            parent.n_children += 1
        self._entries[key] = e
        if partial:
            self._register_fragments(e)
        self._touch(e)
        self.inserts += 1
        return e

    def _make_room(self, protect: set) -> bool:
        """Enforce ``max_cached_pages`` (0 = uncapped) before an insert."""
        cap = self.cfg.max_cached_pages
        if cap <= 0:
            return True
        while len(self._entries) >= cap:
            if self._evict_one(protect) is None:
                return False
        return True

    # --------------------------------------------------------------- eviction
    def _evict_one(self, protect: set = frozenset()) -> Optional[int]:
        """Drop the least-recently-used evictable entry — a chain *leaf*
        (no cached extension) whose page only the cache still references —
        and release its pool reference.  Returns the page id (now on the
        free list) or None when nothing is evictable."""
        victim = None
        for e in self._entries.values():
            if e.key in protect or e.n_children > 0:
                continue
            if self.pool.refcount(e.page) != 1:
                continue            # a running request still shares it
            if victim is None or e.last_used < victim.last_used:
                victim = e
        if victim is None:
            return None
        del self._entries[victim.key]
        if victim.partial:
            self._drop_fragments(victim)
        if victim.parent is not None:
            self._entries[victim.parent].n_children -= 1
        self._demote(victim)
        self.pool.free([victim.page])
        self.evictions += 1
        return victim.page

    def _demote(self, victim: _Entry) -> None:
        """Park the evicted entry in the host tier before its page goes
        back to the free list.  Full entries stash their insert-time
        snapshot — those bits are already exact, so no boundary scrub is
        owed; partial tails snapshot the live page through the boundary
        scrub.  A full host store just drops the entry (pre-tier
        behavior)."""
        if self.tiers is None:
            return
        stale = self._host_entries.pop(victim.key, None)
        if stale is not None:
            self.tiers.drop_slot(stale.slot)
        slot = (
            self.tiers.stash_views(victim.snapshot)
            if victim.snapshot is not None
            else self.tiers.demote_page(victim.page)
        )
        if slot is None:
            return
        self._host_entries[victim.key] = _HostEntry(
            key=victim.key,
            slot=slot,
            n_tokens=victim.n_tokens,
            partial=victim.partial,
        )
        self.demotions += 1

    def evict(self, n_pages: int) -> int:
        """Reclaim up to ``n_pages`` pages for the allocator (admission /
        capacity pressure runs the cache dry before preempting a running
        request).  Returns how many pages actually reached the free list."""
        freed = 0
        while freed < max(n_pages, 1):
            if self._evict_one() is None:
                break
            freed += 1
        return freed

    # ------------------------------------------------------------ observation
    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "cached_pages": self.cached_pages,
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "cow_forks": self.cow_forks,
            "reuse_scrubs": self.reuse_scrubs,
            "reuse_ref_repairs": self.reuse_ref_repairs,
            "reuse_skips": self.reuse_skips,
            "fragment_hits": self.fragment_hits,
            "host_entries": len(self._host_entries),
            "demotions": self.demotions,
            "promotions": self.promotions,
        }
