"""Approximate-memory runtime: ``ApproxConfig``, ``ApproxSpace`` and the
``RepairPlan`` every repair pass runs through."""
from ..core.rules import Detector, RepairRule, RuleSet  # noqa: F401
from .config import ApproxConfig, AutopilotConfig, ScrubSchedule  # noqa: F401
from .plan import RepairPlan, serving_scope  # noqa: F401
from .space import ApproxSpace  # noqa: F401

__all__ = [
    "ApproxConfig", "ApproxSpace", "AutopilotConfig", "Detector", "RepairPlan", "RepairRule",
    "RuleSet", "ScrubSchedule", "serving_scope",
]
