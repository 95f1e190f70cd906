"""Online guard: the loop-closing runtime monitor (reference
``autopilot/guard.py``).

The frontier's assignment is only as good as the conditions it profiled
under: a hotter DRAM part, a workload whose values sit closer to the
exponent cliff, or simple profile staleness all push a group's *observed*
fault rate above the profiled expectation.  The guard watches for that
drift and tightens the drifting group's rule — measurement flowing back
into policy, with hysteresis so one noisy window cannot cascade.

Mechanics: every ``window`` steps the guard reads the per-rule fatal
counters (``ApproxSpace.rule_stats()``), takes each guarded label's delta
since the last window, and compares it against

    tolerance × expected_faults_per_step × window + floor

(``AutopilotConfig.threshold``).  ``patience`` consecutive over-threshold
windows trip the label; a trip tightens its rule ONE stage and starts a
``cooldown`` (windows ignored for that label), and a clean window resets
the strike count.

The tightening ladder (stages per label):

  1. **stricter rule** — detection widened to NaN+Inf and the trigger
     promoted to ``boundary`` (fires on every scheduled pass); if the rule
     is already that strict, a range guard (``max_magnitude``) is added so
     legal-float exponent drift — invisible to the NaN/Inf detector that is
     under-counting relative to the profile — becomes repairable.
  2. **exact demotion** — ``RepairRule.exact_rule``: the group moves to the
     exact-ECC island (nominal refresh), leaving injection and repair
     entirely.

Rules are swapped via ``ApproxSpace.set_rules`` with the label preserved
(``RuleSet.with_rule``), so counter ledgers and expectations stay keyed
identically across a tighten.  A consumer that decided something from
the old rules at construction must decide it again when ``observe()``
returns decisions: ``serving.Engine.step`` recomputes its paged plan (the
kernels' detectors and fills, and whether the paged lanes run at all).
The train step plans its boundary scrub on every call, so
``launch.train.train_loop`` needs nothing beyond what ``set_rules``
clears.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ..core.rules import RepairRule
from ..runtime.config import AutopilotConfig

__all__ = ["OnlineGuard"]

_RANGE_GUARD = 1e3      # the training default's drift/corruption separatrix


def _stricter(rule: RepairRule) -> Optional[RepairRule]:
    """One stage stricter than ``rule``, or ``None`` when only the exact
    demotion is left."""
    det = rule.detect
    if not (det.nan and det.inf) or rule.trigger != "boundary":
        return dataclasses.replace(
            rule,
            detect=dataclasses.replace(det, nan=True, inf=True),
            trigger="boundary",
        )
    if det.max_magnitude is None:
        return dataclasses.replace(
            rule, detect=dataclasses.replace(det, max_magnitude=_RANGE_GUARD)
        )
    return None


class OnlineGuard:
    """Per-window fault monitor over one ``ApproxSpace``.

    Drive it either with ``tick()`` once per production step (it observes
    every ``cfg.window`` ticks) or with ``observe()`` directly at window
    boundaries the caller schedules.  Both return the window's tightening
    decisions — empty when nothing drifted."""

    def __init__(self, space: Any, cfg: AutopilotConfig):
        self.space = space
        self.cfg = cfg
        self._steps = 0
        self._windows = 0
        self._last: Dict[str, int] = {}
        self._strikes: Dict[str, int] = {}
        self._cooldown: Dict[str, int] = {}
        self._stage: Dict[str, int] = {}
        self.trips: List[Dict[str, Any]] = []
        # baseline snapshot: counters accumulated before the guard armed
        # belong to no window
        for label, _ in cfg.expected:
            self._last[label] = self._observed(label)

    # ------------------------------------------------------------------ drive
    def tick(self) -> List[Dict[str, Any]]:
        """One production step; observes every ``cfg.window`` ticks."""
        self._steps += 1
        if self._steps % self.cfg.window == 0:
            return self.observe()
        return []

    def observe(self) -> List[Dict[str, Any]]:
        """Close one observation window: compare each guarded label's fault
        delta against its threshold, apply hysteresis, tighten trippers.
        Returns the tightening decisions (also appended to ``trips``)."""
        self._windows += 1
        decisions: List[Dict[str, Any]] = []
        for label, _ in self.cfg.expected:
            observed = self._observed(label)
            delta = observed - self._last.get(label, 0)
            self._last[label] = observed
            if self._cooldown.get(label, 0) > 0:
                self._cooldown[label] -= 1
                continue
            if self._stage.get(label, 0) >= 2:
                continue            # already exact — nothing left to tighten
            threshold = self.cfg.threshold(label)
            if delta > threshold:
                self._strikes[label] = self._strikes.get(label, 0) + 1
                if self._strikes[label] >= self.cfg.patience:
                    decisions.append(self._tighten(label, delta, threshold))
                    self._strikes[label] = 0
            else:
                self._strikes[label] = 0
        return decisions

    # -------------------------------------------------------------- internals
    def _observed(self, label: str) -> int:
        row = self.space.rule_stats().get(label)
        return 0 if row is None else row["nan_found"] + row["inf_found"]

    def _tighten(
        self, label: str, observed: int, threshold: float
    ) -> Dict[str, Any]:
        ruleset = self.space.ruleset
        current = None
        for _, rule in ruleset.entries:
            if rule.label == label:
                current = rule
                break
        if current is None:
            raise KeyError(f"guarded label {label!r} not bound in RuleSet")
        nxt = _stricter(current) if self._stage.get(label, 0) == 0 else None
        if nxt is None:
            nxt = RepairRule.exact_rule(label=label)
            action = "exact"
            self._stage[label] = 2
        else:
            action = "stricter"
            self._stage[label] = self._stage.get(label, 0) + 1
        self.space.set_rules(ruleset.with_rule(label, nxt))
        self._cooldown[label] = self.cfg.cooldown
        decision = {
            "label": label,
            "action": action,
            "window": self._windows,
            "observed": int(observed),
            "threshold": float(threshold),
            "stage": self._stage[label],
        }
        self.trips.append(decision)
        return decision

    def summary(self) -> Dict[str, Any]:
        return {
            "windows": self._windows,
            "trips": len(self.trips),
            "stages": dict(self._stage),
        }
