"""`ApproxConfig` — the one frozen configuration of the approximate-memory
runtime: repair mode and fill, the refresh→BER point, region rules, the
scrub schedule, an optional ``RuleSet`` and the autopilot's online-guard
contract (``AutopilotConfig``).  Attribute-compatible with the
reference's."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from ..core import injection as injection_lib
from ..core import regions as regions_lib
from ..core import repair as repair_lib
from ..core import rules as rules_lib

_MODES = ("off", "register", "memory")


@dataclasses.dataclass(frozen=True)
class ScrubSchedule:
    """When the memory-repairing mechanism runs: every step boundary, and
    every ``interval`` steps (0 disables the periodic pass)."""

    boundary: bool = True
    interval: int = 0

    def due(self, t: int) -> bool:
        return bool(self.interval) and t % self.interval == 0


@dataclasses.dataclass(frozen=True)
class AutopilotConfig:
    """The online guard's contract, emitted by the autopilot's frontier
    solver (``autopilot.frontier``).  Every ``window`` steps the guard takes
    each guarded label's fatal-event delta from ``rule_stats()`` and calls
    it a strike above ``tolerance × expected × window + floor``
    (``threshold``); ``patience`` consecutive strikes tighten the label's
    rule one stage, after which ``cooldown`` windows are ignored for it.

      window     steps per observation window
      tolerance  multiplier over the profiled expectation
      floor      absolute event slack added to every threshold
      patience   consecutive over-threshold windows before tightening
      cooldown   windows to ignore a label after tightening it
      expected   ordered (rule label, expected fatal events per step); a
                 dict is normalised to its sorted items
    """

    window: int = 8
    tolerance: float = 4.0
    floor: float = 4.0
    patience: int = 2
    cooldown: int = 2
    expected: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.window <= 0:
            raise ValueError("autopilot window must be positive")
        if self.patience <= 0:
            raise ValueError("autopilot patience must be positive")
        if isinstance(self.expected, dict):
            object.__setattr__(self, "expected", tuple(sorted(self.expected.items())))

    def expected_rate(self, label: str) -> float:
        """Profiled fatal events per step for ``label`` (0.0 if unknown)."""
        for name, rate in self.expected:
            if name == label:
                return float(rate)
        return 0.0

    def threshold(self, label: str) -> float:
        """Observed events per window above this are a strike."""
        return self.tolerance * self.expected_rate(label) * self.window + self.floor


@dataclasses.dataclass(frozen=True)
class ApproxConfig:
    """Repair (mode, policy, include_inf, max_magnitude), the simulated
    memory (refresh_interval_s, ber), regions, schedule, rules and the
    online guard (``autopilot``: ``None`` disables it; an
    ``AutopilotConfig`` arms it in ``launch.train.train_loop``, while
    serving has its own switch, ``ServingConfig.autopilot``)."""

    mode: str = "memory"
    policy: Any = "neighbor_mean"
    include_inf: bool = True
    max_magnitude: Optional[float] = None

    refresh_interval_s: float = 1.0
    ber: Optional[float] = None

    region_rules: Tuple[Tuple[str, regions_lib.Region], ...] = (
        regions_lib.DEFAULT_RULES
    )
    scrub: ScrubSchedule = ScrubSchedule()
    rules: Optional[rules_lib.RuleSet] = None
    autopilot: Optional[AutopilotConfig] = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"bad repair mode {self.mode!r}")
        if isinstance(self.rules, (tuple, list)):
            object.__setattr__(self, "rules", rules_lib.RuleSet(tuple(self.rules)))

    @property
    def ruleset(self) -> rules_lib.RuleSet:
        if self.rules is not None:
            return self.rules
        return rules_lib.RuleSet.from_legacy(self)

    @property
    def memory_model(self) -> injection_lib.ApproxMemoryModel:
        return injection_lib.ApproxMemoryModel.from_refresh(self.refresh_interval_s)

    @property
    def resolved_ber(self) -> float:
        return self.ber if self.ber is not None else self.memory_model.ber

    def expected_faults(self, n_bytes: int, windows: float,
                        ber: Optional[float] = None) -> float:
        """Expected fatal-bit count of ``n_bytes`` of approximate memory
        after ``windows`` refresh windows: ``bits × ber × windows`` (the
        per-window BER is memoryless, so the expectation is linear in dwell
        time).  ``ber`` defaults to the refresh model's; the serving prefix
        cache passes the engine's simulation BER."""
        b = self.resolved_ber if ber is None else ber
        return float(n_bytes) * 8.0 * float(b) * max(float(windows), 0.0)

    @staticmethod
    def from_legacy(cfg: Any, **overrides) -> "ApproxConfig":
        """Lift any object with the four repair fields (an ``ApproxConfig``
        included) into an ``ApproxConfig``."""
        if isinstance(cfg, ApproxConfig):
            return dataclasses.replace(cfg, **overrides) if overrides else cfg
        fields = dict(
            mode=cfg.mode,
            policy=cfg.policy,
            include_inf=cfg.include_inf,
            max_magnitude=getattr(cfg, "max_magnitude", None),
        )
        fields.update(overrides)
        return ApproxConfig(**fields)

    def legacy(self):
        """The equivalent legacy ``RepairConfig`` (for shim delegation)."""
        return repair_lib.RepairConfig(
            mode=self.mode,
            policy=self.policy,
            include_inf=self.include_inf,
            max_magnitude=self.max_magnitude,
        )

    def memory_forced(self) -> "ApproxConfig":
        """Same config with mode pinned to "memory": the save scrub and the
        cache scrubs run the memory-repairing mechanism even when the run
        itself is register-mode or off."""
        return dataclasses.replace(self, mode="memory")
