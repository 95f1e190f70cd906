"""`Engine` — continuous batching over the paged approximate-memory KV pool.

    engine = Engine(model, ServingConfig(...))          # device="cuda"
    rid = engine.add_request(prompt_ids, max_new=32)
    while engine.has_work:
        out = engine.step()          # {"emitted": {rid: [tok]}, "finished"}
    engine.results[rid]["tokens"]    # prompt + generated

One step:

  0. the deferred stats drain (``drain_interval > 0``, when due)
  1. one approximate-memory window strikes the pool (``ber > 0`` only)
  2. admission: waiting requests get zeroed pages and a decode slot, or,
     with the prefix cache, the shared pages of their longest cached prefix
     and fresh pages for the rest; on the gathered prefill a probe over the
     fresh pages and the null page runs first.  A request swapped out to
     the host tier is written back instead of re-prefilled.  A cache hit's
     scrub on reuse and copy-on-write fork run next (``prepare_hit``), then,
     on the gathered prefill, one ``Model.prefill`` per admission over the
     request's gathered view, from the first uncached position
  3. the paged prefill lane: one prompt chunk per mid-prefill request
     through the paged prefill kernel, straight off the pool (a cache hit's
     suffix starts at its match length), then ONE reactive scrub from the
     summed per-page fatal counts, so a page shared by several requests is
     charged once a step
  4. one decode step over the static ``(max_batch, M)`` slot batch: through
     the paged decode kernel (split-K when ``resolve_split_k() > 1``), then
     the reactive scrub of the pages its counts flagged; or, on the
     gathered fallback, the probe of the touched pages, their scrub, then
     ``Model.serve_step`` over the gathered view
  5. the background sweep tick
  6. the online autopilot guard (``cfg.autopilot``): every ``window``
     steps it reads ``rule_stats()``; a trip tightens a drifting label's
     rule (``space.set_rules``), and the engine decides its paged lanes
     again from the new rules (``_plan_lanes``), draining the deferred
     counters first if the paged lanes went away

The paged paths run wherever the model and the pool rules allow
(``_paged_decode_plan``); the gathered view is the fallback the reference
keeps for the rest: ``paged_decode="off"``, ``repair="off"`` (the kernels
always repair what they read), non-memory spaces, a register-mode model
(its use-site repair replaces the kernels'), and fills without a kernel
form.  ``paged_prefill="off"`` gathers only the prefill.  On the card, a
pool where not even one KV head's page fits a block's shared memory
(``kernels.paged_attention.pool_refusal``; no pool of the registry) is
refused when the lanes are planned, before any launch.

Lockstep (``drain_interval == 0``) reads each lane's kernel counters back
and acts on them within the step.  With ``drain_interval = N`` the paged
lanes' counters accumulate on the device and one readback every N steps
drives the scrub of the union of flagged pages: the kernels repair on read
with a value-independent fill, so the tokens do not depend on when the
scrub writes the repair back, and ``n_host_syncs`` falls.

A prefix is cached once its prefill completes (``PrefixCache.insert``,
before the request can finish).  ``cache_stats()`` and ``tier_stats()``
report the cache and the host tier.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as device_lib
from ..autopilot.guard import OnlineGuard
from ..core import stats as stats_lib
from ..core.regions import Region
from ..kernels import common as kernels_common
from ..kernels import paged_attention as paged_kernel
from ..launch.serve import build_serve_step
from ..runtime import ApproxSpace, ScrubSchedule
from ..runtime.plan import serving_scope
from .config import ServingConfig
from .pool import PagedKVPool
from .prefix_cache import PrefixCache
from .repair import PageRepairManager
from .scheduler import Request, RequestState, Scheduler
from .tiers import TierManager


def engine_space(model: Any) -> ApproxSpace:
    """The engine's default runtime: memory mode, NaN/Inf only, zero fill,
    no boundary scrub (the page repair manager owns every scrub)."""
    return ApproxSpace(
        model.cfg.repair,
        mode="memory",
        policy="zero",
        max_magnitude=None,
        scrub=ScrubSchedule(boundary=False, interval=0),
    )


@dataclasses.dataclass(frozen=True)
class _PagedDecodePlan:
    """One detector (``None`` = detection off) and one kernel fill per
    pool-leaf name, shared by the decode and prefill kernels; ``prefill``
    says whether admission runs the paged prefill kernel too."""

    detectors: Mapping[str, Any]
    fills: Mapping[str, Tuple[str, float]]
    prefill: bool = False


def _paged_decode_plan(
    model: Any, space: ApproxSpace, pool: PagedKVPool, cfg: ServingConfig
) -> Optional[_PagedDecodePlan]:
    """The kernels' repair spec, or ``None`` where the reference falls back
    to the gathered view: ``repair="off"``, non-memory modes, register-mode
    model reads, fills without a bit-identical kernel form, detectors that
    do not encode into the constants, or leaves of one name disagreeing.
    Decided before any launch, from the configuration alone."""
    if not getattr(model, "supports_paged_decode", False):
        return None
    if serving_scope(cfg.repair) == "none" or space.config.mode != "memory":
        return None
    if getattr(model.cfg.repair, "mode", "off") == "register":
        return None
    regions = space.regions_for(pool.tree)
    rules, _ = space.rules_for(pool.tree)
    detectors: Dict[str, Any] = {}
    fills: Dict[str, Tuple[str, float]] = {}
    for path, leaf in pool.tree.items():
        name = path.rsplit("/", 1)[-1]
        rule = rules[path]
        if (
            not leaf.is_floating_point()
            or regions[path] is not Region.APPROX
            or not rule.fires("reactive")
        ):
            det, fill = None, ("zero", 0.0)
        else:
            fill = kernels_common.kernel_fill(rule.fill)
            if fill is None:
                return None
            try:
                rule.detect.constants(leaf.dtype)
            except (TypeError, ValueError):
                return None
            det = rule.detect
        if name in detectors and detectors[name] != det:
            return None
        if det is not None and fills.get(name, fill) != fill:
            return None
        detectors[name] = det
        if det is not None or name not in fills:
            fills[name] = fill
    return _PagedDecodePlan(
        detectors=detectors, fills=fills,
        prefill=(bool(getattr(model, "supports_paged_prefill", False))
                 and cfg.paged_prefill == "auto"),
    )


class Engine:
    """Continuous-batching serving engine (add_request / step / run)."""

    def __init__(
        self,
        model: Any,
        cfg: Optional[ServingConfig] = None,
        space: Optional[ApproxSpace] = None,
        *,
        device=None,
    ):
        self.device = device_lib.resolve(device)
        if model.device != self.device:
            raise ValueError(
                f"model weights are on {model.device}, engine on {self.device}"
            )
        if not getattr(model, "supports_paged_kv", False):
            raise NotImplementedError(
                f"{type(model).__name__} has no paged KV layout"
            )
        if not getattr(model, "supports_batched_prefill", False):
            raise NotImplementedError(
                f"{type(model).__name__} cannot batched-prefill"
            )
        self.model = model
        self.cfg = cfg or ServingConfig()
        self.space = space or engine_space(model)
        self.pool = PagedKVPool(model, self.space, self.cfg, device=self.device)
        self.n_host_syncs = 0
        self.stage_wall_s: Dict[str, float] = {
            "admit": 0.0, "prefill": 0.0, "decode": 0.0, "repair": 0.0,
            "guard": 0.0,
        }
        self.tiers = (TierManager(self.pool, self.space, self.cfg)
                      if self.cfg.host_pages > 0 else None)
        self.cache = (PrefixCache(self.pool, self.space, self.cfg, tiers=self.tiers)
                      if self.cfg.prefix_cache else None)
        self.sched = Scheduler(self.pool, self.cfg, cache=self.cache,
                               tiers=self.tiers)
        self.repair = PageRepairManager(
            self.pool, self.space, self.cfg, on_host_sync=self._note_host_sync
        )
        # the greedy step of the gathered fallback, shared with generate
        self._step_fn = self.space.wrap_serve_step(build_serve_step(model))
        self._plan_lanes()
        self._split_k = self.cfg.resolve_split_k()
        self._prefilling: List[Request] = []
        self.kernel_counts = np.zeros(8, np.int64)
        # desynchronized drain (``_desync``): the paged lanes' counters
        # accumulate on the device, (n_pages + 1 + 8,) int32, read back
        # once per drain
        self._pending: Optional[torch.Tensor] = None
        self._pending_covered: set = set()
        self._pending_attr: List[Tuple[List[int], int]] = []
        self._steps_since_drain = 0
        self._stream = stats_lib.zeros()
        self.results: Dict[int, Dict[str, Any]] = {}
        self._next_rid = 0
        self._t = 0
        self._generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + 1
        )
        self._last_touched: List[int] = []
        self.tokens_emitted = 0
        self.prefill_tokens_saved = 0
        # tokens a re-prefill processed again after a recompute preemption
        self.prefill_tokens_recomputed = 0
        self.guard = (OnlineGuard(self.space, self.cfg.autopilot)
                      if self.cfg.autopilot is not None else None)
        self.autopilot_trips = 0

    def _plan_lanes(self) -> None:
        """Decide the paged lanes from the space's rules as they stand: the
        kernels' detectors and fills, whether admission runs the paged
        prefill, and whether the drain is desynchronized.  At construction,
        and again after an autopilot trip."""
        self.paged_plan = (
            _paged_decode_plan(self.model, self.space, self.pool, self.cfg)
            if self.cfg.paged_decode == "auto" else None
        )
        self._paged_prefill = (
            self.paged_plan is not None and self.paged_plan.prefill
        )
        if self.paged_plan is not None and self.device.type == "cuda":
            why = paged_kernel.pool_refusal(
                self.model.cfg.n_heads, self.pool.tree["layers/k"],
                self.pool.tree["layers/v"], prefill=self._paged_prefill,
            )
            if why:
                raise NotImplementedError(
                    f"{why}: serve this pool with paged_decode='off' "
                    "(ROADMAP.md §3)"
                )
        self._desync = self.cfg.drain_interval > 0 and self.paged_plan is not None

    # ------------------------------------------------------------------ admit
    def add_request(self, prompt: Sequence[int], max_new: int) -> int:
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        rid = self._next_rid
        self._next_rid += 1
        self.sched.add(Request(rid=rid, prompt=prompt, max_new=int(max_new)))
        return rid

    @property
    def has_work(self) -> bool:
        return self.sched.has_work

    # ------------------------------------------------------------------- step
    @torch.no_grad()
    def step(self) -> Dict[str, Any]:
        """One engine step; returns the tokens emitted and requests finished."""
        t = self._t
        self.pool.now = t
        emitted: Dict[int, List[int]] = {}
        finished: List[int] = []
        self._last_touched = []

        # (0) the deferred drain runs before this step's flips land, so at
        # drain_interval=1 the pool entering (1) is the lockstep engine's
        if self._desync and self._steps_since_drain >= self.cfg.drain_interval:
            self._drain_pending()

        # (1) simulation boundary: one window of flips strikes the pool
        if self.cfg.ber > 0.0:
            self.pool.tree, self._stream = self.space.inject(
                self.pool.tree, self._generator, self.cfg.ber, stats=self._stream
            )

        # (2) admission: fresh pages are zeroed.  The paged prefill kernel
        # is the detector; the gathered prefill probes the fresh pages (the
        # null page rides along) before its whole-prompt pass, whose wall
        # time lands in "admit".  Shared pages are left out of the probe
        # (their admission policy is the scrub on reuse), and so are pages
        # about to take a swapped-in context's exact bits.  A preempted
        # member of the lane leaves it here; a swapped one rejoins it where
        # it left off once swapped in
        t_admit = time.perf_counter()
        self._prefilling = [
            r for r in self._prefilling if r.state is RequestState.RUNNING
        ]
        plan = self.sched.step_plan(self._prefilling)
        if plan.admitted:
            pages = sorted({p for r in plan.admitted for p in r.pages})
            shared = {
                e.page
                for r in plan.admitted if r.cache_hit is not None
                for e in (*r.cache_hit.full, r.cache_hit.partial) if e is not None
            }
            swapped = {p for r in plan.admitted if r.swap is not None
                       for p in r.pages}
            fresh = sorted(set(pages) - shared - swapped)
            if fresh and not self._paged_prefill:
                self._stream = self.repair.repair_step(fresh, self._stream)
            self._last_touched = pages
        for req in plan.admitted:
            if req.swap is not None:
                handle, req.swap = req.swap, None
                self.tiers.swap_in(handle, req.pages)
                if req.prefill_pos is not None and self._paged_prefill:
                    self._prefilling.append(req)
                continue
            if self.cache is not None:
                self._stream = self.cache.prepare_hit(req, self._stream)
            if self._paged_prefill:
                if req.prefill_pos is None:
                    req.prefill_pos = 0
                self._prefilling.append(req)
                continue
            self._prefill(req, emitted)
            if self.cache is not None:
                # before finish: the cache's own references keep the
                # prefix resident when the request finishes at once
                self.cache.insert(req)
            if req.state is RequestState.RUNNING and self._maybe_finish(req):
                finished.append(req.rid)
        self.stage_wall_s["admit"] += time.perf_counter() - t_admit

        # (3) the prefill lane, then one reactive pass over its summed counts
        if self._prefilling:
            t_pre = time.perf_counter()
            page_counts = counts = None
            covered = {self.pool.null_page}
            still: List[Request] = []
            for req in self._prefilling:
                pc_r, cnt_r, done = self._prefill_paged(req, emitted)
                page_counts = pc_r if page_counts is None else page_counts + pc_r
                counts = cnt_r if counts is None else counts + cnt_r
                covered.update(req.pages)
                if not done:
                    still.append(req)
                    continue
                if self.cache is not None:
                    self.cache.insert(req)
                if req.state is RequestState.RUNNING and self._maybe_finish(req):
                    finished.append(req.rid)
            self._prefilling = still
            self._last_touched = sorted(
                set(self._last_touched) | (covered - {self.pool.null_page})
            )
            self.stage_wall_s["prefill"] += time.perf_counter() - t_pre
            self._flush_lane(page_counts, counts, covered)

        # (4) one decode step + the reactive repair pass
        decodable = []
        for r in plan.decode:
            if r.state is not RequestState.RUNNING:
                continue
            if self._reserve_next_page(r):
                decodable.append(r)
        decodable = [r for r in decodable if r.state is RequestState.RUNNING]
        if decodable:
            touched = sorted(
                set(self._last_touched) | {p for r in decodable for p in r.pages}
            )
            self._last_touched = touched
            if self.paged_plan is not None:
                t_dec = time.perf_counter()
                page_counts, counts = self._decode_paged(decodable, emitted)
                self.stage_wall_s["decode"] += time.perf_counter() - t_dec
                self._flush_lane(
                    page_counts, counts, set(touched) | {self.pool.null_page}
                )
            else:
                t_rep = time.perf_counter()
                self._stream = self.repair.repair_step(touched, self._stream)
                self.stage_wall_s["repair"] += time.perf_counter() - t_rep
                t_dec = time.perf_counter()
                self._decode(decodable, emitted)
                self.stage_wall_s["decode"] += time.perf_counter() - t_dec
            for req in decodable:
                if self._maybe_finish(req):
                    finished.append(req.rid)

        # (5) background sweep tick
        t_rep = time.perf_counter()
        self._stream = self.repair.sweep_step(t, self._stream)
        self.stage_wall_s["repair"] += time.perf_counter() - t_rep

        # (6) the autopilot guard closes its window; a trip swapped the
        # rules the paged plan was decided from
        if self.guard is not None:
            t_grd = time.perf_counter()
            decisions = self.guard.tick()
            if decisions:
                self.autopilot_trips += len(decisions)
                self._plan_lanes()
                if not self._desync:    # flush before the paged lanes go
                    self.drain()
            self.stage_wall_s["guard"] += time.perf_counter() - t_grd

        if self._desync:
            self._steps_since_drain += 1
        self._t += 1
        for toks in emitted.values():
            self.tokens_emitted += len(toks)
        return {"t": t, "emitted": emitted, "finished": finished}

    def run(self, max_idle_steps: int = 100) -> Dict[int, Dict[str, Any]]:
        """Drive the engine until every queued request finishes."""
        idle = 0
        while self.has_work:
            out = self.step()
            idle = 0 if (out["emitted"] or out["finished"]) else idle + 1
            if idle > max_idle_steps:
                raise RuntimeError(
                    f"engine made no progress in {max_idle_steps} steps"
                )
        self.drain()        # leave nothing parked: scrub what was flagged
        return self.results

    # --------------------------------------------------------------- lanes
    def _note_host_sync(self) -> None:
        self.n_host_syncs += 1

    def _host(self, x) -> np.ndarray:
        """Blocking device→host readback; every hot-path sync funnels here
        (a deferred event delta, already a host count, is charged as the
        reference's device scalar is)."""
        self.n_host_syncs += 1
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def _flush_lane(self, page_counts, counts, covered) -> None:
        """One paged lane's kernel counters.  Lockstep: read both back now
        and run the reactive pass.  Desync: add them into the one device
        accumulator, so a drain costs one readback however many lanes and
        steps it covers."""
        if page_counts is None:
            return
        if self._desync:
            pending = torch.cat([page_counts.to(torch.int32), counts.to(torch.int32)])
            self._pending = (
                pending if self._pending is None else self._pending + pending
            )
            self._pending_covered |= set(covered)
            return
        pc = self._host(page_counts)
        self.kernel_counts += self._host(counts).astype(np.int64)
        t0 = time.perf_counter()
        self._stream = self.repair.repair_counts(pc, covered, self._stream)
        self.stage_wall_s["repair"] += time.perf_counter() - t0

    def _resolve_attr(self) -> None:
        """Charge the per-page ledger with the event deltas a drain-time
        scrub deferred."""
        attrs, self._pending_attr = self._pending_attr, []
        for pages, delta in attrs:
            d = int(self._host(delta))
            if d > 0:
                self.pool.attribute(pages, d)

    def _drain_pending(self) -> None:
        """One drain: resolve the previous drain's attribution, read the
        pending accumulator back in one readback, and scrub the union of
        flagged pages (its own attribution deferred in turn)."""
        self._resolve_attr()
        self._steps_since_drain = 0
        if self._pending is None:
            return
        pend = self._host(self._pending)
        n_rows = self.cfg.n_pages + 1
        page_counts, counts = pend[:n_rows], pend[n_rows:]
        self.kernel_counts += counts.astype(np.int64)
        covered = self._pending_covered
        self._pending = None
        self._pending_covered = set()
        t0 = time.perf_counter()
        self._stream = self.repair.repair_counts(
            page_counts, covered, self._stream, defer=self._pending_attr
        )
        self.stage_wall_s["repair"] += time.perf_counter() - t0

    def drain(self) -> None:
        """Flush every deferred readback: the pending kernel counters, the
        scrub they drive and its ledger attribution.  ``metrics()`` and the
        end of ``run()`` call it; a lockstep engine has nothing to flush."""
        self._drain_pending()
        self._resolve_attr()

    def _page_counts(self, bt: torch.Tensor, slot_counts: torch.Tensor):
        """Per-slot counts scatter-added onto the pool's page axis."""
        n_rows = self.cfg.n_pages + 1
        out = torch.zeros(n_rows, dtype=torch.int32, device=self.device)
        return out.index_add_(0, bt.reshape(-1).long(), slot_counts.reshape(-1))

    def _reserve_next_page(self, req: Request) -> bool:
        req.pos = req.n_context - 1
        return self.sched.ensure_capacity(req)

    def _prefill(self, req: Request, emitted: Dict[int, List[int]]) -> None:
        """The gathered prefill: the (re-)prefill context past the cached
        prefix in one ``Model.prefill`` call over the request's gathered
        pages, from cache position ``req.cached_tokens``."""
        toks = req.prefill_tokens()
        n_cached = req.cached_tokens
        bt = self.pool.block_table(req.pages)[None, :]
        view = self.pool.gather(bt)
        tokens = torch.as_tensor([toks[n_cached:]], dtype=torch.int64,
                                 device=self.device)
        nxt, _, view, self._stream = self._step_fn(view, tokens, n_cached,
                                                   self._stream)
        self.pool.scatter(view, bt)
        req.pos = len(toks)
        self.prefill_tokens_saved += n_cached
        if req.n_preempted:
            self.prefill_tokens_recomputed += len(toks) - n_cached
        tok = int(self._host(nxt)[0])
        req.tokens.append(tok)
        emitted.setdefault(req.rid, []).append(tok)

    def _prefill_paged(self, req: Request, emitted: Dict[int, List[int]]):
        """One prompt chunk straight off the pool (``prefill_chunk == 0``:
        the whole remaining context); a cache hit's first chunk starts at
        its match length.  Returns the per-page fatal counts and the counter
        vector as device tensors, and whether the prefill is complete (the
        first token is emitted only then)."""
        toks = req.prefill_tokens()
        start = req.cached_tokens + req.prefill_pos
        rest = toks[start:]
        width = len(rest) if self.cfg.prefill_chunk == 0 else self.cfg.prefill_chunk
        chunk = rest[:width]
        q_len = len(chunk)
        padded = chunk + [0] * (width - q_len)
        dev = self.device
        bt = torch.as_tensor(self.pool.block_table(req.pages)[None, :], device=dev)
        logits, slot_counts, counts = self.model.prefill_paged(
            self.pool.tree,
            torch.as_tensor([padded], dtype=torch.int64, device=dev),
            bt,
            torch.tensor([start], dtype=torch.int32, device=dev),
            torch.tensor([q_len], dtype=torch.int32, device=dev),
            detectors=self.paged_plan.detectors, fills=self.paged_plan.fills,
        )
        nxt = logits[0, max(q_len - 1, 0)].argmax()
        page_counts = self._page_counts(bt, slot_counts)
        req.prefill_pos += q_len
        done = start + q_len >= len(toks)
        if done:
            req.pos = len(toks)
            req.prefill_pos = None
            self.prefill_tokens_saved += req.cached_tokens
            if req.n_preempted:
                self.prefill_tokens_recomputed += len(toks) - req.cached_tokens
            tok = int(self._host(nxt))
            req.tokens.append(tok)
            emitted.setdefault(req.rid, []).append(tok)
        return page_counts, counts, done

    def _decode_batch(self, reqs: List[Request]):
        """The static-shape decode batch: block tables, tokens, positions."""
        B, M = self.cfg.max_batch, self.cfg.max_pages_per_request
        bt = np.full((B, M), self.pool.null_page, np.int32)
        tokens = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int32)
        for req in reqs:
            bt[req.slot] = self.pool.block_table(req.pages)
            tokens[req.slot, 0] = req.last_token
            pos[req.slot] = req.pos
        return bt, tokens, pos

    def _emit(self, reqs: List[Request], nxt: torch.Tensor,
              emitted: Dict[int, List[int]]) -> None:
        nxt = self._host(nxt)
        for req in reqs:
            tok = int(nxt[req.slot])
            req.tokens.append(tok)
            req.pos += 1
            emitted.setdefault(req.rid, []).append(tok)

    def _decode(self, reqs: List[Request], emitted: Dict[int, List[int]]) -> None:
        """The gathered-view decode over the static slot batch."""
        bt, tokens, pos = self._decode_batch(reqs)
        dev = self.device
        view = self.pool.gather(bt)
        nxt, _, view, self._stream = self._step_fn(
            view, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(pos, device=dev), self._stream,
        )
        self.pool.scatter(view, bt)
        self._emit(reqs, nxt, emitted)

    def _decode_paged(self, reqs: List[Request], emitted: Dict[int, List[int]]):
        bt, tokens, pos = self._decode_batch(reqs)
        dev = self.device
        bt = torch.as_tensor(bt, device=dev)
        logits, slot_counts, counts = self.model.serve_step_paged(
            self.pool.tree, torch.as_tensor(tokens, device=dev), bt,
            torch.as_tensor(pos, device=dev),
            detectors=self.paged_plan.detectors, fills=self.paged_plan.fills,
            split_k=self._split_k,
        )
        self._emit(reqs, logits[:, -1, :].argmax(dim=-1), emitted)
        return self._page_counts(bt, slot_counts), counts

    def _maybe_finish(self, req: Request) -> bool:
        if req.done or req.n_context >= self.cfg.max_seq:
            req.truncated = not req.done
            self.sched.finish(req)
            self.results[req.rid] = {
                "tokens": req.prompt + req.tokens,
                "generated": list(req.tokens),
                "n_preempted": req.n_preempted,
                "truncated": req.truncated,
            }
            return True
        return False

    # ----------------------------------------------------------- observation
    def record_kernel(self, counts) -> None:
        """Report an externally run kernel's counter vector: folded into
        the stats and routed back to the pages the last step touched."""
        self.repair.note_kernel(counts, self._last_touched)

    def unified_stats(self) -> stats_lib.Stats:
        return stats_lib.merge(self.space.stats, self._stream)

    def stats_dict(self) -> Dict[str, int]:
        return stats_lib.as_dict(self.unified_stats())

    def rule_stats(self) -> Dict[str, Dict[str, int]]:
        return self.space.rule_stats()

    def cache_stats(self) -> Dict[str, Any]:
        """The prefix cache's counters (``{"enabled": False, ...}`` when it
        is off)."""
        out: Dict[str, Any] = {
            "enabled": self.cache is not None,
            "prefill_tokens_saved": self.prefill_tokens_saved,
        }
        if self.cache is not None:
            out.update(self.cache.stats())
        return out

    def tier_stats(self) -> Dict[str, Any]:
        """The host tier's counters: swap traffic, the boundary-scrub byte
        ledger and the recompute fallbacks (``{"enabled": False, ...}`` when
        ``host_pages == 0``)."""
        out: Dict[str, Any] = {
            "enabled": self.tiers is not None,
            "swap_policy": self.cfg.swap_policy,
            "n_swap_preemptions": self.sched.n_swap_preemptions,
            "prefill_tokens_recomputed": self.prefill_tokens_recomputed,
        }
        if self.tiers is not None:
            out.update(self.tiers.stats())
        return out

    def metrics(self) -> Dict[str, Any]:
        self.drain()        # metrics reflect a fully flushed engine
        toks = max(self.tokens_emitted, 1)
        steps = max(self._t, 1)
        return {
            "tokens_emitted": self.tokens_emitted,
            "steps": self._t,
            "n_host_syncs": self.n_host_syncs,
            "host_syncs_per_step": self.n_host_syncs / steps,
            "drain_interval": self.cfg.drain_interval,
            "stage_wall_s": dict(self.stage_wall_s),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefill_tokens_recomputed": self.prefill_tokens_recomputed,
            "n_preemptions": self.sched.n_preemptions,
            "n_swap_preemptions": self.sched.n_swap_preemptions,
            "scrubbed_bytes": self.pool.scrubbed_bytes,
            "scrub_calls": self.pool.scrub_calls,
            "scrubbed_bytes_per_token": self.pool.scrubbed_bytes / toks,
            "paged_decode": self.paged_plan is not None,
            "paged_prefill": self._paged_prefill,
            "split_k": self._split_k,
            "pool_gathers": self.pool.n_gathers,
            "pool_scatters": self.pool.n_scatters,
            "paged_kernel_events": int(self.kernel_counts[6]),
            "autopilot_trips": self.autopilot_trips,
            **self.repair.summary(),
        }
