"""`RepairPlan` — what one repair pass covers and how it runs.

  scope       "none"    no-op (non-memory modes)
              "tree"    every approximate-region float leaf
              "pages"   rows ``page_ids`` of the leading page axis
              "reference" fatal lanes take a reference tree's bits (the
                        prefix cache's snapshots): a forced pass in every
                        repair mode, plain ``torch.where`` on each rule's
                        fatal masks, as the reference's has no kernel
              "inject"  the simulation boundary (one bit-flip window)
  placement   decided per leaf: a leaf whose rule has a kernel fill and an
              encodable detector (pages scope: ndim ≥ 2) is scrubbed by the
              scrub wrapper (``kernels.scrub``: its CUDA kernel for tensors
              on the card, its plain version on the CPU), any other leaf by
              the tensor-level rule repair.  Both give the same bits and
              counts for a kernel fill, so a pass that mixes the two (the
              autopilot campaign's ``neighbor_mean`` weights beside a zero-
              fill cache) keeps the kernel for the leaves that have one
              (``kernel_paths``); the reference decides once a pass, since
              its kernel pass is one executable

Page scrubs pad their id list to the next power of two with duplicates of
the first id, whose lanes are repaired but masked out of the counts — the
reference's bucketing, kept so counts and pool bits match it.  Stats are
host integers; per-rule [nan, inf, events] deltas fold into the space's
ledger.  The reference's executable cache, trace counter and buffer
donation are JAX mechanisms and have no counterpart here: passes run
eagerly and update the state dict's tensors in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import injection as injection_lib
from ..core import regions as regions_lib
from ..core import stats as stats_lib
from ..kernels import common as kernels_common
from ..kernels import scrub as scrub_kernel

__all__ = ["RepairPlan", "plan_for", "serving_scope", "SCOPES"]

SCOPES = ("none", "tree", "pages", "reference", "inject")

_SERVING_SCOPE = {"off": "none", "whole": "tree", "page": "pages"}


def serving_scope(repair_mode: str) -> str:
    """Serving repair mode ("off" | "whole" | "page") → plan scope."""
    try:
        return _SERVING_SCOPE[repair_mode]
    except KeyError:
        raise ValueError(f"bad serving repair mode {repair_mode!r}") from None


def is_approx_float(leaf, region) -> bool:
    return region is regions_lib.Region.APPROX and leaf.is_floating_point()


def _bucket(n: int, cap: int) -> int:
    """Next power of two ≥ n, clamped to the page-axis size."""
    b = 1
    while b < n:
        b <<= 1
    return max(1, min(b, cap))


def _kernel_leaf(leaf, rule, scope) -> bool:
    """Whether the scrub kernel repairs ``leaf`` under ``rule`` bit for bit:
    a kernel fill, a detector that encodes into the kernel's constants and,
    for page scrubs, a page axis in front of at least one more."""
    if kernels_common.kernel_fill(rule.fill) is None:
        return False
    if scope == "pages" and leaf.dim() < 2:
        return False
    try:
        rule.detect.constants(leaf.dtype)
    except (TypeError, ValueError):
        return False
    return True


def finish_rule_counts(rc: np.ndarray) -> np.ndarray:
    """Append the per-rule events column (≥1 fatal lane = one event)."""
    events = ((rc[:, 0] + rc[:, 1]) > 0).astype(np.int64)[:, None]
    return np.concatenate([rc, events], axis=1)


@dataclasses.dataclass
class RepairPlan:
    space: Any
    scope: str
    regions: Dict[str, regions_lib.Region]
    rules: Dict[str, Any]
    indices: Dict[str, int]
    n_rules: int
    trigger: str
    bytes_per_run: int
    page_row_bytes: int
    page_capacity: int
    ber: Optional[float] = None
    kernel_paths: frozenset = frozenset()

    def _firing(self, tree):
        for path, leaf in tree.items():
            rule = self.rules[path]
            if (
                is_approx_float(leaf, self.regions[path])
                and rule.fires(self.trigger)
                and leaf.numel()
            ):
                yield path, leaf, rule

    def _fold(self, per_leaf, rules_out=None) -> stats_lib.Stats:
        """Sum per-leaf [nan, inf] count tensors with ONE host readback,
        fold them into the rule ledger (or into ``rules_out``), return the
        stats delta."""
        rc = np.zeros((self.n_rules, 2), np.int64)
        values = np.zeros((0, 2), np.int64)
        if per_leaf:
            values = torch.stack([c[:2].to(torch.int64) for _, c in per_leaf])
            values = values.cpu().numpy()
            for (path, _), (n, i) in zip(per_leaf, values):
                rc[self.indices[path]] += (n, i)
        if rules_out is None:
            self.space.record_rule_counts(finish_rule_counts(rc))
        else:
            rules_out += finish_rule_counts(rc)
        return stats_lib.record_repair(
            stats_lib.zeros(), int(values[:, 0].sum()), int(values[:, 1].sum())
        )

    @torch.no_grad()
    def run(
        self,
        tree: Dict[str, torch.Tensor],
        *,
        page_ids=None,
        generator: Optional[torch.Generator] = None,
        reference: Optional[Dict[str, torch.Tensor]] = None,
        rules_out: Optional[np.ndarray] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Any]:
        """Run the pass over ``tree`` (tensors updated in place, outside
        autograd).  Returns ``(tree, stats delta)``, or ``(tree, n_flips)``
        for "inject".  A tree pass adds its per-rule [nan, inf, events]
        delta into ``rules_out`` (int64 [n_rules, 3]) when given, instead
        of the space's ledger."""
        if self.scope == "none":
            return tree, (0 if self.ber is not None else stats_lib.zeros())
        if self.scope == "inject":
            return tree, self._inject(tree, generator)
        if self.scope == "reference":
            return tree, self._fold([
                (p, reference_leaf(leaf, rule, reference[p]))
                for p, leaf, rule in self._firing(tree)
            ])
        if self.scope == "tree":
            return tree, self._fold(
                [(p, self._scrub_leaf(p, leaf, rule))
                 for p, leaf, rule in self._firing(tree)],
                rules_out,
            )
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        if ids.size == 0:
            return tree, stats_lib.zeros()
        bucket = _bucket(ids.size, max(self.page_capacity, ids.size))
        padded = np.full((bucket,), ids[0], np.int64)
        padded[: ids.size] = ids
        return tree, self._fold([
            (p, self._scrub_pages_leaf(p, leaf, rule, padded, ids.size))
            for p, leaf, rule in self._firing(tree)
        ])

    @torch.no_grad()
    def run_copies(self, tree: Dict[str, torch.Tensor],
                   sink: Callable[[str, torch.Tensor], None]) -> stats_lib.Stats:
        """The pass on copies, one leaf at a time: each leaf the pass
        repairs is cloned on its device, the clone repaired as ``run``
        repairs it and handed to ``sink(path, clone)``; every other leaf
        goes to ``sink`` as it is.  ``tree`` keeps its bits, and the extra
        device memory is one leaf.  The counts are one pass's, as ``run``
        gives them (the save scrub of ``checkpoint.CheckpointManager``)."""
        assert self.scope == "tree", self.scope
        firing = {p for p, _, _ in self._firing(tree)}
        per_leaf = []
        for path, leaf in tree.items():
            if path in firing:
                leaf = leaf.clone()
                per_leaf.append((path, self._scrub_leaf(path, leaf, self.rules[path])))
            sink(path, leaf)
        return self._fold(per_leaf)

    def _scrub_leaf(self, path, leaf, rule) -> torch.Tensor:
        if path in self.kernel_paths:
            policy, constant = kernels_common.kernel_fill(rule.fill)
            return scrub_kernel.scrub(
                leaf, policy=policy, constant=constant, detector=rule.detect
            )[1]
        fixed, n, i = rule.apply(leaf)
        leaf.copy_(fixed)
        return torch.stack([n, i])

    def _scrub_pages_leaf(self, path, leaf, rule, padded, n_valid) -> torch.Tensor:
        if path in self.kernel_paths:
            policy, constant = kernels_common.kernel_fill(rule.fill)
            return scrub_kernel.scrub_pages(
                leaf, padded, policy=policy, constant=constant,
                detector=rule.detect, n_valid=n_valid,
            )[1]
        idx = torch.as_tensor(padded, device=leaf.device)
        rows = leaf[idx]
        nan_m, inf_m = rule.detect.masks(rows)
        mask = nan_m | inf_m
        leaf[idx] = torch.where(mask, rule.resolved_fill()(rows, mask), rows)
        valid = (torch.arange(len(padded), device=leaf.device) < n_valid)
        valid = valid.reshape((-1,) + (1,) * (rows.dim() - 1))
        return torch.stack([(nan_m & valid).sum(), (inf_m & valid).sum()])

    def _inject(self, tree, generator) -> int:
        flips = 0
        for path, leaf in tree.items():
            if not is_approx_float(leaf, self.regions[path]):
                continue
            flipped, n = injection_lib.flip_bits_counted(leaf, self.ber, generator)
            leaf.copy_(flipped)
            flips += n
        return flips


def reference_leaf(leaf, rule, ref) -> torch.Tensor:
    """Reference repair of one leaf, in place: its fatal lanes (by the
    rule's detector) take ``ref``'s bits.  Returns its [nan, inf] counts."""
    nan_m, inf_m = rule.detect.masks(leaf)
    ref = ref.to(device=leaf.device, dtype=leaf.dtype)
    leaf.copy_(torch.where(nan_m | inf_m, ref, leaf))
    return torch.stack([nan_m.sum(), inf_m.sum()])


def plan_for(
    space: Any,
    tree: Dict[str, torch.Tensor],
    *,
    scope: str = "tree",
    ber: Optional[float] = None,
    trigger: str = "forced",
    regions: Optional[Dict[str, regions_lib.Region]] = None,
) -> RepairPlan:
    """Plan one pass over ``tree`` for ``space`` (cached per scope, trigger,
    layout, rule set and region mask).  ``regions`` (``{path: Region}``)
    overrides the space's region classification: the autopilot campaign's
    mask that confines an injection window to one group."""
    if scope not in SCOPES:
        raise ValueError(f"bad plan scope {scope!r}; expected one of {SCOPES}")
    if scope in ("tree", "pages") and space.config.mode != "memory":
        scope = "none"
    if scope not in ("tree", "pages"):
        trigger = "forced"
    layout = tuple(
        (path, tuple(leaf.shape), str(leaf.dtype)) for path, leaf in tree.items()
    )
    extra = float(ber) if scope == "inject" else None
    mask = None if regions is None else tuple(regions[p] for p in tree)
    key = (scope, trigger, layout, extra, space.ruleset.digest(), mask)
    plan = space._plan_cache.get(key)
    if plan is not None:
        return plan
    if regions is None:
        regions = space.regions_for(tree)
    rules, indices = space.rules_for(tree)
    firing = [
        p for p, leaf in tree.items()
        if is_approx_float(leaf, regions[p]) and rules[p].fires(trigger)
        and leaf.numel()
    ] if scope in ("tree", "pages") else []
    kernel_paths = frozenset(
        p for p in firing if _kernel_leaf(tree[p], rules[p], scope))
    approx_bytes = page_row_bytes = page_capacity = 0
    for path, leaf in tree.items():
        if not is_approx_float(leaf, regions[path]):
            continue
        if scope in ("tree", "pages") and not rules[path].fires(trigger):
            continue
        nbytes = leaf.numel() * leaf.element_size()
        approx_bytes += nbytes
        if leaf.dim() >= 1 and leaf.shape[0]:
            page_row_bytes += nbytes // leaf.shape[0]
            page_capacity = (
                leaf.shape[0] if page_capacity == 0
                else min(page_capacity, leaf.shape[0])
            )
    plan = RepairPlan(
        space=space, scope=scope, regions=regions,
        rules=rules, indices=indices, n_rules=space.ruleset.n_rules,
        trigger=trigger, bytes_per_run=0 if scope == "none" else approx_bytes,
        page_row_bytes=page_row_bytes, page_capacity=max(page_capacity, 1),
        ber=extra, kernel_paths=kernel_paths,
    )
    space._plan_cache[key] = plan
    return plan
