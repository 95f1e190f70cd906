"""`RepairRule` — Detector × Fill × Trigger, bound to state paths.

  Detector   which stored bit patterns are fatal: NaN, ±Inf, an exponent
             range guard (``max_magnitude``) or one custom per-dtype bit
             pattern ((bits & mask) == value, counted as NaN)
  Fill       the repair value (``core.policies``)
  Trigger    which scheduled passes repair the leaf (boundary ⊃ interval ⊃
             reactive; on-read leaves only at use sites; "forced" passes
             repair every non-exact leaf)

A ``RuleSet`` binds rules to state paths by ordered regexes, first match
wins, with a catch-all default — the same grammar, labels and digests as
the reference, so rule sets carry over unchanged.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from . import detect, policies

__all__ = [
    "Detector", "RepairRule", "RuleSet", "TRIGGERS", "PASSES", "ruleset_of",
]

TRIGGERS = ("boundary", "interval", "reactive", "on-read")
PASSES = ("boundary", "interval", "reactive", "forced")

_FIRES = {
    "boundary": frozenset(("boundary", "interval", "reactive", "forced")),
    "interval": frozenset(("interval", "reactive", "forced")),
    "reactive": frozenset(("reactive", "forced")),
    "on-read": frozenset(("forced",)),
}

# Detector-constants layout for the kernels (int32[8]):
#   0 exp_mask   1 man_mask   2 flags   3 range exp-field threshold (shifted)
#   4 bitpattern mask   5 bitpattern value   6 count-valid row bound   7 pad
FLAG_NAN, FLAG_INF, FLAG_RANGE, FLAG_BITPATTERN = 1, 2, 4, 8

_DTYPE_NAMES = {
    "float64": torch.float64, "float32": torch.float32,
    "bfloat16": torch.bfloat16, "float16": torch.float16,
}


def _dtype_matches(name: Optional[str], dtype: torch.dtype) -> bool:
    """Does a bit-pattern entry's dtype name (reference spelling, e.g.
    "bfloat16") apply to ``dtype``?  ``None`` matches every dtype."""
    return name is None or _DTYPE_NAMES.get(str(name)) == dtype


@dataclasses.dataclass(frozen=True)
class Detector:
    """Which stored bit patterns are fatal (see module docstring)."""

    nan: bool = True
    inf: bool = True
    max_magnitude: Optional[float] = None
    bitpatterns: Tuple[Tuple[Optional[str], int, int], ...] = ()

    def masks(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(nan_mask, inf_mask) of the fatal lanes of ``x``.  With
        ``max_magnitude`` the range guard owns the non-NaN bucket (±Inf
        included); otherwise ``inf`` gates the ±Inf pattern."""
        bits = detect.bits_of(x)
        if self.nan:
            nan_m = detect.is_nan_bits(bits, x.dtype)
        else:
            nan_m = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        lay = detect.layout_of(x.dtype)
        for dt, mask, value in self.bitpatterns:
            if not _dtype_matches(dt, x.dtype):
                continue
            m = detect.signed(int(mask), lay.width)
            v = detect.signed(int(value), lay.width)
            nan_m = nan_m | ((bits & m) == v)
        if self.max_magnitude is not None:
            ext = detect.is_extreme_bits(bits, x.dtype, self.max_magnitude)
            inf_m = ext & ~nan_m
        elif self.inf:
            inf_m = detect.is_inf_bits(bits, x.dtype)
        else:
            inf_m = torch.zeros_like(nan_m)
        return nan_m, inf_m

    def constants(self, dtype: torch.dtype) -> Tuple[int, ...]:
        """The int32[8] kernel encoding of this detector for ``dtype``, as
        unsigned values (``kernels.common.detector_operand`` folds them into
        int32 by two's complement)."""
        lay = detect.layout_of(dtype)
        if lay.width > 32:
            raise TypeError(
                f"kernel detectors support dtypes up to 32 bits, got {dtype}"
            )
        flags = 0
        if self.nan:
            flags |= FLAG_NAN
        range_field = 0
        if self.max_magnitude is not None:
            flags |= FLAG_RANGE
            range_field = (
                detect.exp_field_of(self.max_magnitude, dtype) << lay.man_bits
            )
        elif self.inf:
            flags |= FLAG_INF
        bp_mask = bp_value = 0
        for dt, mask, value in self.bitpatterns:
            if not _dtype_matches(dt, dtype):
                continue
            if flags & FLAG_BITPATTERN:
                raise ValueError(
                    "kernels support at most one bitpattern per dtype"
                )
            flags |= FLAG_BITPATTERN
            bp_mask, bp_value = int(mask), int(value)
        return (
            lay.exp_mask, lay.man_mask, flags, range_field,
            bp_mask, bp_value, 0, 0,
        )

    def key(self) -> Tuple:
        return ("det", self.nan, self.inf, self.max_magnitude, self.bitpatterns)


@dataclasses.dataclass(frozen=True)
class RepairRule:
    """Detector × Fill × Trigger for one protection class of leaves."""

    detect: Detector = Detector()
    fill: Any = "neighbor_mean"       # name | float | RepairPolicy
    trigger: str = "boundary"
    exact: bool = False               # ECC-like exact island: never repaired
    label: str = ""                   # stats key; defaults to the pattern

    def __post_init__(self):
        if self.trigger not in TRIGGERS:
            raise ValueError(
                f"bad trigger {self.trigger!r}; expected one of {TRIGGERS}"
            )

    @staticmethod
    def exact_rule(label: str = "exact") -> "RepairRule":
        """The matched leaves live in exact memory: never injected, never
        repaired."""
        return RepairRule(exact=True, label=label)

    def resolved_fill(self) -> policies.RepairPolicy:
        return policies.get(self.fill)

    def fires(self, pass_tag: str) -> bool:
        if self.exact:
            return False
        return pass_tag in _FIRES[self.trigger]

    def apply(self, x: torch.Tensor):
        """(repaired, nan_count, inf_count) of one tensor under this rule;
        counts are 0-d int64 tensors on ``x``'s device."""
        nan_m, inf_m = self.detect.masks(x)
        mask = nan_m | inf_m
        fixed = torch.where(mask, self.resolved_fill()(x, mask), x)
        return fixed, nan_m.sum(), inf_m.sum()

    def key(self) -> Tuple:
        fill = self.fill
        if isinstance(fill, policies.RepairPolicy):
            fill = fill.name
        return (self.detect.key(), fill, self.trigger, self.exact)


DEFAULT_RULE = RepairRule(label="default")


@dataclasses.dataclass(frozen=True)
class RuleSet:
    """Ordered (pattern, RepairRule) bindings over state paths."""

    entries: Tuple[Tuple[str, RepairRule], ...]

    def __post_init__(self):
        entries = []
        for pattern, rule in tuple(self.entries):
            if not rule.label:
                rule = dataclasses.replace(rule, label=pattern)
            entries.append((pattern, rule))
        object.__setattr__(self, "entries", tuple(entries))

    @staticmethod
    def single(rule: RepairRule) -> "RuleSet":
        if not rule.label:
            rule = dataclasses.replace(rule, label="default")
        return RuleSet(entries=((r".*", rule),))

    @staticmethod
    def from_legacy(cfg: Any) -> "RuleSet":
        """Lift scalar repair fields into a one-rule set."""
        return RuleSet.single(
            RepairRule(
                detect=Detector(
                    nan=True,
                    inf=cfg.include_inf,
                    max_magnitude=getattr(cfg, "max_magnitude", None),
                ),
                fill=cfg.policy,
                trigger="boundary",
                label="default",
            )
        )

    @property
    def table(self) -> Tuple[RepairRule, ...]:
        return tuple(r for _, r in self.entries) + (DEFAULT_RULE,)

    def labels(self) -> Tuple[str, ...]:
        """Stats keys by rule index; duplicates are suffixed ``#n``."""
        out, seen = [], {}
        for rule in self.table:
            n = seen.get(rule.label, 0)
            seen[rule.label] = n + 1
            out.append(rule.label if n == 0 else f"{rule.label}#{n}")
        return tuple(out)

    def rule_for(self, path: str) -> Tuple[int, RepairRule]:
        """(index, rule) for one rendered path (first match wins)."""
        for i, (pattern, rule) in enumerate(self.entries):
            if re.search(pattern, path):
                return i, rule
        return len(self.entries), DEFAULT_RULE

    def read_rule(self) -> RepairRule:
        """The rule a pathless ``use()`` read applies: the first non-exact
        on-read rule, else the first non-exact rule, else the fallback."""
        for _, rule in self.entries:
            if rule.trigger == "on-read" and not rule.exact:
                return rule
        for _, rule in self.entries:
            if not rule.exact:
                return rule
        return DEFAULT_RULE

    def assign(
        self, tree: Mapping[str, Any]
    ) -> Tuple[Dict[str, RepairRule], Dict[str, int]]:
        """(``{path: rule}``, ``{path: rule index}``) for a flat state dict."""
        rules, indices = {}, {}
        for path in tree:
            indices[path], rules[path] = self.rule_for(path)
        return rules, indices

    def with_rule(self, label: str, rule: RepairRule) -> "RuleSet":
        """A copy with the entry labeled ``label`` replaced by ``rule``:
        same pattern, same position, same label (the replacement is
        relabeled), so the per-rule ledger and the autopilot guard's
        expectations stay keyed identically across a tighten.  Raises
        ``KeyError`` when no entry carries the label."""
        entries, found = [], False
        for pattern, existing in self.entries:
            if not found and existing.label == label:
                entries.append((pattern, dataclasses.replace(rule, label=label)))
                found = True
            else:
                entries.append((pattern, existing))
        if not found:
            raise KeyError(f"no rule labeled {label!r} in this RuleSet")
        return RuleSet(entries=tuple(entries))

    @property
    def n_rules(self) -> int:
        return len(self.entries) + 1

    def digest(self) -> Tuple:
        return tuple((p, r.key()) for p, r in self.entries)


def ruleset_of(cfg: Any) -> RuleSet:
    rs = getattr(cfg, "ruleset", None)
    if rs is not None:
        return rs
    return RuleSet.from_legacy(cfg)
