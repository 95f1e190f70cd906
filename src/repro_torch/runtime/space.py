"""`ApproxSpace` — the runtime object owning approximate memory: regions
and rule assignments per state layout, the unified stats stream (kernel
counter vectors included), the memory-mode scrubs, the simulation boundary
and the per-rule ledger.

State is a flat ``{path: tensor}`` dict (``core.regions``); passes update
its tensors in place and return the same dict.  Every mechanism has a pure
form (pass ``stats``, get ``(tree, stats')`` back) and a convenience form
(omit ``stats``; deltas accumulate in ``self.stats``).  ``use`` is the
register-mode read of one tensor; unlike the passes it returns a repaired
copy and leaves its input as it was, as does ``scrub_copies`` (the
checkpoint manager's save scrub).  ``scrub_with_reference`` restores
fatal lanes from a reference tree (the prefix cache's page snapshots, a
restored checkpoint).  ``wrap_serve_step`` and ``wrap_train_step`` install
the boundary scrub around a serve step and a train step.  ``set_rules``
swaps the rule set at run time (the autopilot guard).  Not ported:
meshes (ROADMAP slice 6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import regions as regions_lib
from ..core import rules as rules_lib
from ..core import stats as stats_lib
from .config import ApproxConfig

__all__ = ["ApproxSpace", "read_rule", "use_tensor"]

Tree = Dict[str, torch.Tensor]


def read_rule(cfg: Any, path: str = "") -> Optional[rules_lib.RepairRule]:
    """The rule a use-site read of ``path`` repairs with, or ``None`` where
    the read is the identity: mode off, an exact-island rule, or a rule
    that fires on read only in register mode outside it.  ``path`` binds
    the ruleset's rule for that path; a pathless read takes
    ``RuleSet.read_rule``.  Depends on ``cfg`` and ``path`` alone, so a
    caller can decide once whether a read site can ever repair."""
    if cfg.mode == "off":
        return None
    ruleset = rules_lib.ruleset_of(cfg)
    rule = ruleset.rule_for(path)[1] if path else ruleset.read_rule()
    if rule.exact:
        return None
    if cfg.mode != "register" and rule.trigger != "on-read":
        return None
    return rule


def use_tensor(
    x: torch.Tensor, cfg: Any, stats: Optional[stats_lib.Stats],
    path: str = "",
) -> Tuple[torch.Tensor, Optional[stats_lib.Stats]]:
    """Register-mode read (paper §3.3): repair at the consumption site.

    The identity outside register mode, except for a bound *on-read* rule,
    which repairs here in every mode (``read_rule``).  Returns
    ``(repaired, stats')``; ``x`` itself is not modified.  With ``stats``
    None the counts are not read back and ``None`` is returned for them."""
    rule = read_rule(cfg, path)
    if rule is None:
        return x, stats
    fixed, n, i = rule.apply(x)
    if stats is None:
        return fixed, None
    return fixed, stats_lib.record_repair(stats, n, i)


class ApproxSpace:
    """The runtime service over one approximate-memory deployment::

        space = ApproxSpace(ApproxConfig(mode="memory", policy="zero"))
        space = ApproxSpace(model.cfg.repair, policy="zero")   # overrides
    """

    def __init__(self, config: Any = None, *, mesh: Any = None, **overrides):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-native ApproxSpace is not ported: ROADMAP slice 6 "
                "(multi-GPU)"
            )
        rules = overrides.get("rules")
        if rules is not None and not isinstance(rules, rules_lib.RuleSet):
            overrides["rules"] = rules_lib.RuleSet(tuple(rules))
        if config is None:
            config = ApproxConfig(**overrides)
        else:
            config = ApproxConfig.from_legacy(config, **overrides)
        self.config: ApproxConfig = config
        self.stats: stats_lib.Stats = stats_lib.zeros()
        self.scrubbed_bytes: int = 0
        self._region_cache: Dict[Any, Dict[str, regions_lib.Region]] = {}
        self._rule_cache: Dict[Any, Tuple[Dict, Dict]] = {}
        self._plan_cache: Dict[Any, Any] = {}
        self._rule_counts: Optional[np.ndarray] = None
        self._ruleset: rules_lib.RuleSet = config.ruleset

    @property
    def ruleset(self) -> rules_lib.RuleSet:
        return self._ruleset

    def plan_for(self, tree: Tree, *, scope: str = "tree",
                 ber: Optional[float] = None, trigger: str = "forced",
                 regions: Optional[Dict[str, regions_lib.Region]] = None):
        from . import plan as plan_lib

        return plan_lib.plan_for(self, tree, scope=scope, ber=ber,
                                 trigger=trigger, regions=regions)

    def set_rules(self, ruleset: rules_lib.RuleSet) -> "ApproxSpace":
        """Swap in a new ``RuleSet`` at run time (the autopilot guard's
        tightening).  The rule, region and plan caches are cleared; the
        per-rule ledger survives when the labels are unchanged (the guard
        replaces rules in place) and is reset when they change."""
        old_labels = self._ruleset.labels()
        self.config = dataclasses.replace(self.config, rules=ruleset)
        self._ruleset = self.config.ruleset
        self._rule_cache.clear()
        self._region_cache.clear()
        self._plan_cache.clear()
        if self._rule_counts is not None and self._ruleset.labels() != old_labels:
            self._rule_counts = None
        return self

    # ---------------------------------------------------------------- regions
    def rules_for(self, tree: Tree) -> Tuple[Dict[str, Any], Dict[str, int]]:
        """(``{path: RepairRule}``, ``{path: rule index}``), cached by the
        state's paths."""
        key = tuple(tree)
        hit = self._rule_cache.get(key)
        if hit is None:
            hit = self.ruleset.assign(tree)
            self._rule_cache[key] = hit
        return hit

    def regions_for(self, tree: Tree) -> Dict[str, regions_lib.Region]:
        """``{path: Region}``; an exact-island rule pins its leaves EXACT."""
        key = tuple(tree)
        hit = self._region_cache.get(key)
        if hit is None:
            regions = regions_lib.annotate(tree, self.config.region_rules)
            rules, _ = self.rules_for(tree)
            hit = {
                p: regions_lib.Region.EXACT if rules[p].exact else r
                for p, r in regions.items()
            }
            self._region_cache[key] = hit
        return hit

    def region_bytes(self, tree: Tree) -> Tuple[int, int]:
        """(approx_bytes, exact_bytes) of ``tree`` under this space's rules."""
        return regions_lib.count_bytes(tree, self.regions_for(tree))

    # ------------------------------------------------------------- mechanisms
    def use(self, x: torch.Tensor, stats: Optional[stats_lib.Stats] = None,
            *, path: str = ""):
        """Register-mode read of one tensor (see ``use_tensor``).  With
        ``stats``: ``(repaired, stats')``; otherwise the repaired tensor,
        its counts recorded into ``self.stats``."""
        if stats is not None:
            return use_tensor(x, self.config, stats, path)
        fixed, self.stats = use_tensor(x, self.config, self.stats, path)
        return fixed

    def scrub(self, tree: Tree, stats: Optional[stats_lib.Stats] = None, *,
              trigger: str = "forced"):
        """Memory-mode repair of every approximate float leaf, in place."""
        plan = self.plan_for(tree, scope="tree", trigger=trigger)
        out, delta = plan.run(tree)
        self.scrubbed_bytes += plan.bytes_per_run
        return self._thread_stats(out, delta, stats)

    def scrub_pages(self, tree: Tree, page_ids: Any,
                    stats: Optional[stats_lib.Stats] = None, *,
                    trigger: str = "forced"):
        """Repair rows ``page_ids`` of the leading (page) axis of every
        approximate float leaf, in place — the serving engine's page-
        granular scrub.  Ids are bucketed to a power of two (padding
        duplicates masked out of the counts)."""
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        if ids.size == 0 or self.config.mode != "memory":
            return self._thread_stats(tree, stats_lib.zeros(), stats)
        plan = self.plan_for(tree, scope="pages", trigger=trigger)
        out, delta = plan.run(tree, page_ids=ids)
        self.scrubbed_bytes += int(ids.size) * plan.page_row_bytes
        return self._thread_stats(out, delta, stats)

    def scrub_with_reference(self, tree: Tree, ref_tree: Tree,
                             stats: Optional[stats_lib.Stats] = None):
        """Reference repair, in place: each approximate float leaf's fatal
        lanes, by its rule's detector, take ``ref_tree``'s exact bits.  A
        forced pass, in every repair mode (an explicit request)."""
        plan = self.plan_for(tree, scope="reference")
        out, delta = plan.run(tree, reference=ref_tree)
        self.scrubbed_bytes += plan.bytes_per_run
        return self._thread_stats(out, delta, stats)

    def scrub_copies(self, tree: Tree, sink) -> None:
        """``scrub``'s pass on copies: each repaired leaf is cloned, the
        clone scrubbed (through the scrub kernel where ``scrub`` would use
        it) and handed to ``sink(path, clone)`` one leaf at a time, every
        other leaf as it is (``RepairPlan.run_copies``).  ``tree`` keeps
        its bits; the counts land in ``self.stats`` and the rule ledger as
        ``scrub``'s do."""
        plan = self.plan_for(tree, scope="tree")
        self.stats = stats_lib.merge(self.stats, plan.run_copies(tree, sink))
        self.scrubbed_bytes += plan.bytes_per_run

    def _thread_stats(self, out, delta, stats):
        if stats is None:
            self.stats = stats_lib.merge(self.stats, delta)
            return out
        return out, stats_lib.merge(stats, delta)

    def inject(self, tree: Tree, generator: torch.Generator,
               ber: Optional[float] = None, *,
               stats: Optional[stats_lib.Stats] = None,
               record: bool = True,
               regions: Optional[Dict[str, regions_lib.Region]] = None):
        """One approximate-memory window of bit flips over the approximate
        region (in place).  With ``stats``: ``(tree, stats')``; otherwise
        ``(tree, n_flips)``, recorded into ``self.stats`` unless
        ``record=False``.  ``regions`` (``{path: Region}``) overrides
        ``regions_for``: the autopilot campaign's mask confining a window
        to one region group."""
        ber = self.config.resolved_ber if ber is None else ber
        if ber <= 0.0:
            flips = 0
        else:
            plan = self.plan_for(tree, scope="inject", ber=ber, regions=regions)
            tree, flips = plan.run(tree, generator=generator)
        if stats is not None:
            return tree, stats_lib.record_flips(stats, flips)
        if record:
            self.stats = stats_lib.record_flips(self.stats, flips)
        return tree, flips

    def wrap_serve_step(self, fn):
        """Install the boundary scrub around a raw serve step
        ``fn(cache, tokens, pos) -> (*outs, cache)``.  The wrapped step
        threads an explicit stats stream::

            step(cache, tokens, pos, stats) -> (*outs, cache, stats)

        In memory mode with a boundary schedule the resident cache is
        scrubbed before the step, so the step reads it clean."""

        def step(cache, tokens, pos, stats):
            if self.config.mode == "memory" and self.config.scrub.boundary:
                cache, stats = self.scrub(cache, stats, trigger="boundary")
            return (*fn(cache, tokens, pos), stats)

        return step

    def wrap_train_step(self, fn):
        """Install the boundary scrub around a raw train step
        ``fn(state, batch) -> (state, metrics)`` over the flat train state
        (``params/...``, ``opt/...``, ``stats`` and, where the reference
        has it, ``rule_counts``; ``launch.train``).

        In memory mode with a boundary schedule, ``params`` and ``opt`` are
        scrubbed in one "boundary" pass before the step, in place: through
        the scrub kernel on the card where every firing rule has a kernel
        fill (``runtime.plan``), else the tensor-level repair.  Its counts
        go into ``state["stats"]`` (one event at most a pass) and its
        per-rule delta into ``state["rule_counts"]``, which ``train_loop``
        folds into ``rule_stats()`` once; a state without that block drops
        the per-rule delta, as the reference's in-jit scrub does."""

        def step(state, batch):
            if self.config.mode == "memory" and self.config.scrub.boundary:
                resident = {p: t for p, t in state.items()
                            if p.startswith(("params/", "opt/"))}
                plan = self.plan_for(resident, scope="tree", trigger="boundary")
                rc = np.zeros((self.ruleset.n_rules, 3), np.int64)
                _, delta = plan.run(resident, rules_out=rc)
                self.scrubbed_bytes += plan.bytes_per_run
                state = {**state, "stats": stats_lib.merge(state["stats"], delta)}
                if "rule_counts" in state:
                    state["rule_counts"] = state["rule_counts"] + rc
            return fn(state, batch)

        return step

    # ------------------------------------------------------------------ stats
    def record(self, delta: stats_lib.Stats) -> stats_lib.Stats:
        """Merge a stats delta (e.g. a wrapped step's) into the stream."""
        self.stats = stats_lib.merge(self.stats, delta)
        return self.stats

    def record_kernel(self, counts) -> stats_lib.Stats:
        """Fold a kernel counter vector (int32[8]) into the stream."""
        self.stats = stats_lib.record_kernel_counts(self.stats, counts)
        return self.stats

    def record_rule_counts(self, rule_counts: np.ndarray) -> None:
        """Fold one pass's per-rule [nan, inf, events] delta."""
        if self._rule_counts is None:
            self._rule_counts = np.zeros((self.ruleset.n_rules, 3), np.int64)
        self._rule_counts = self._rule_counts + rule_counts

    def rule_stats(self) -> Dict[str, Dict[str, int]]:
        labels = self.ruleset.labels()
        rc = (
            np.zeros((len(labels), 3), np.int64)
            if self._rule_counts is None else self._rule_counts
        )
        return {
            label: {
                "nan_found": int(rc[i, 0]),
                "inf_found": int(rc[i, 1]),
                "events": int(rc[i, 2]),
            }
            for i, label in enumerate(labels)
        }

    def stats_dict(self) -> Dict[str, int]:
        return stats_lib.as_dict(self.stats)
