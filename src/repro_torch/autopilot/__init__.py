"""EDEN-style BER autopilot: profile → solve → guard (reference
``repro.autopilot``; README §Autopilot).

Three layers close the loop between the approximate-memory model and the
application's measured error tolerance:

  campaign   per-region-group refresh sweeps under injection — emits a
             ``ToleranceProfile`` of quality-vs-BER cells
  frontier   solves the profile against a quality budget — per-group
             refresh map, deployment ``RuleSet`` (exact-ECC islands for
             collapsed groups), and the online guard's expectations
  guard      runtime monitor over ``ApproxSpace.rule_stats()`` that
             tightens drifting groups' rules with hysteresis
"""
from .campaign import (
    CampaignConfig,
    ProfileCell,
    RegionGroup,
    ToleranceProfile,
    campaign_space,
    group_regions,
    run_campaign,
)
from .frontier import (
    NOMINAL_REFRESH_S,
    FrontierAssignment,
    GroupAssignment,
    solve_frontier,
)
from .guard import OnlineGuard

__all__ = [
    "CampaignConfig",
    "FrontierAssignment",
    "GroupAssignment",
    "NOMINAL_REFRESH_S",
    "OnlineGuard",
    "ProfileCell",
    "RegionGroup",
    "ToleranceProfile",
    "campaign_space",
    "group_regions",
    "run_campaign",
    "solve_frontier",
]
