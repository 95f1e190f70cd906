"""Frontier solver: EDEN's assignment step (reference
``autopilot/frontier.py``; pure Python, its JSON the reference's byte for
byte).

Given a ``ToleranceProfile`` and a stated quality budget, pick the most
aggressive (longest) refresh interval each region group tolerates:

  * a group whose measured quality at some profiled point stays within the
    budget is assigned the longest such refresh — its deployed rule from the
    profile binds at that point;
  * a group whose curve **collapses** (no profiled point within budget)
    is demoted to an **exact-ECC island** at nominal refresh —
    ``RepairRule.exact_rule`` removes its leaves from injection and repair
    alike (recurrent SSM/xLSTM state is the expected case: its errors
    compound across steps with no attention-style amortization).

The assignment emits three deployment artifacts:

  ``refresh_map()``   per-group pattern → refresh interval (the DRAM
                      controller's per-allocation parameter table)
  ``ruleset()``       the concrete ``RuleSet`` — exact islands for collapsed
                      groups, the groups' relaxed rules elsewhere, in the
                      profile's binding order
  ``autopilot()``     the ``AutopilotConfig`` contract for the online guard:
                      per-group expected fault rates at the assigned points

plus ``energy_saving`` — the byte-weighted refresh-model saving over the
profiled bytes (collapsed groups contribute the nominal point's 0%).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Tuple

from ..core.rules import RepairRule, RuleSet
from ..runtime.config import AutopilotConfig
from .campaign import RegionGroup, ToleranceProfile, rule_to_json

__all__ = ["GroupAssignment", "FrontierAssignment", "solve_frontier"]

NOMINAL_REFRESH_S = 0.064           # JEDEC-compliant anchor (BER ~1e-17)


@dataclasses.dataclass(frozen=True)
class GroupAssignment:
    """One group's point on the frontier."""

    group: str
    pattern: str
    refresh_s: float
    ber: float
    energy_saving: float
    quality: float                  # measured quality at the assigned point
    collapsed: bool                 # True → exact-ECC island at nominal
    expected_faults_per_step: float
    approx_bytes: int


@dataclasses.dataclass(frozen=True)
class FrontierAssignment:
    """The solved frontier: per-group refresh + the deployment artifacts."""

    budget: float
    metric: str
    groups: Tuple[RegionGroup, ...]
    assignments: Tuple[GroupAssignment, ...]

    def assignment(self, name: str) -> GroupAssignment:
        for a in self.assignments:
            if a.group == name:
                return a
        raise KeyError(f"no assignment for group {name!r}")

    def refresh_map(self) -> Dict[str, float]:
        """pattern → assigned refresh interval (seconds)."""
        return {a.pattern: a.refresh_s for a in self.assignments}

    def ruleset(self) -> RuleSet:
        """The concrete deployment ``RuleSet``: collapsed groups become
        exact-ECC islands, the rest keep their profiled rules — bound in
        the profile's group order (first match wins, like the campaign)."""
        entries = []
        by_name = {a.group: a for a in self.assignments}
        for g in self.groups:
            a = by_name[g.name]
            rule = (
                RepairRule.exact_rule(label=g.name) if a.collapsed
                else g.labeled_rule()
            )
            entries.append((g.pattern, rule))
        return RuleSet(tuple(entries))

    def autopilot(
        self,
        window: int = 8,
        tolerance: float = 4.0,
        floor: float = 4.0,
        patience: int = 2,
        cooldown: int = 2,
    ) -> AutopilotConfig:
        """The online-guard contract: each non-collapsed group's profiled
        fault rate at its assigned point becomes the guard's expectation
        (collapsed groups are exact — nothing to guard, expectation 0)."""
        expected = tuple(
            (a.group, 0.0 if a.collapsed else a.expected_faults_per_step)
            for a in self.assignments
        )
        return AutopilotConfig(
            window=window, tolerance=tolerance, floor=floor,
            patience=patience, cooldown=cooldown, expected=expected,
        )

    @property
    def energy_saving(self) -> float:
        """Byte-weighted refresh-model saving over the profiled bytes."""
        total = sum(a.approx_bytes for a in self.assignments)
        if total == 0:
            return 0.0
        return sum(
            a.energy_saving * a.approx_bytes for a in self.assignments
        ) / total

    def to_json(self) -> str:
        return json.dumps({
            "budget": self.budget,
            "metric": self.metric,
            "groups": [g.to_json() for g in self.groups],
            "assignments": [dataclasses.asdict(a) for a in self.assignments],
            "ruleset": [
                {"pattern": p, "rule": rule_to_json(r)}
                for p, r in self.ruleset().entries
            ],
            "energy_saving": self.energy_saving,
        }, indent=2)

    @staticmethod
    def from_json(text: str) -> "FrontierAssignment":
        d = json.loads(text)
        return FrontierAssignment(
            budget=d["budget"],
            metric=d["metric"],
            groups=tuple(RegionGroup.from_json(g) for g in d["groups"]),
            assignments=tuple(
                GroupAssignment(**a) for a in d["assignments"]
            ),
        )


def solve_frontier(
    profile: ToleranceProfile, budget: float
) -> FrontierAssignment:
    """Pick, per group, the longest profiled refresh whose measured quality
    stays within ``budget`` (non-finite quality — a diverged episode —
    never qualifies).  Groups with no qualifying point collapse to the
    exact island at nominal refresh."""
    assignments: List[GroupAssignment] = []
    for g in profile.groups:
        cells = profile.group_cells(g.name)
        ok = [
            c for c in cells
            if math.isfinite(c.quality) and c.quality <= budget
        ]
        if ok:
            best = max(ok, key=lambda c: c.refresh_s)
            assignments.append(GroupAssignment(
                group=g.name,
                pattern=g.pattern,
                refresh_s=best.refresh_s,
                ber=best.ber,
                energy_saving=best.energy_saving,
                quality=best.quality,
                collapsed=False,
                expected_faults_per_step=best.faults_per_step,
                approx_bytes=best.approx_bytes,
            ))
        else:
            nbytes = max((c.approx_bytes for c in cells), default=0)
            assignments.append(GroupAssignment(
                group=g.name,
                pattern=g.pattern,
                refresh_s=NOMINAL_REFRESH_S,
                ber=0.0,
                energy_saving=0.0,
                quality=0.0,
                collapsed=True,
                expected_faults_per_step=0.0,
                approx_bytes=int(nbytes),
            ))
    return FrontierAssignment(
        budget=float(budget),
        metric=profile.metric,
        groups=profile.groups,
        assignments=tuple(assignments),
    )
