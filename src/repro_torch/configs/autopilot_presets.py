"""Profiled autopilot presets (reference ``configs/autopilot_presets.py``;
README §Autopilot).

One preset per model family the acceptance story needs: a dense
transformer (qwen2) and a recurrent state-space stack (xLSTM).  Each
bundles the CPU-scale architecture, the region grouping (weights vs the
long-lived decode state), and the campaign geometry — ``run_campaign``
over a preset is the whole profiling story in one call.

The grouping encodes the paper's central asymmetry:

  * **weight groups** carry the training-defaults rule — NaN/Inf plus a
    range guard (``max_magnitude=1e3``) repaired by ``neighbor_mean`` —
    because a flipped weight is read fresh from memory every step and a
    bounded excursion amortizes over the ensemble;
  * **state groups** (KV cache / recurrent mLSTM-sLSTM state) carry the
    NaN/Inf-only zero-fill rule: legal-float exponent flips pass the
    detector and *compound* through the recurrence, so the campaign is
    expected to measure collapse at aggressive refresh — exactly the
    signal the frontier solver turns into an exact-ECC island.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..core.rules import Detector, RepairRule
from ..runtime import ApproxConfig
from . import get_config
from .base import ArchConfig

# NOTE: repro_torch.autopilot.campaign reaches back through launch/ and
# models/ into this package, so the campaign types are imported inside the
# preset functions (not at module scope) to keep the imports acyclic.

__all__ = [
    "AutopilotPreset",
    "PRESETS",
    "get_preset",
    "preset_names",
    "recurrent_preset",
    "transformer_preset",
]

# the training-defaults rule for weight groups: range-guarded, ensemble
# fill — bounded drift instead of collapse under exponent flips
_WEIGHT_RULE = RepairRule(
    detect=Detector(nan=True, inf=True, max_magnitude=1e3),
    fill="neighbor_mean",
    trigger="boundary",
)

# four refresh points spanning the anchor table's interesting span:
# 0.256 s (BER 1e-9, 16.1 % saving), 1.0 s (1e-6, 22.5 %), the
# interpolated 2.0 s (1e-5, ~25 %), and 4.0 s (1e-4, 30 %).  2.0 s is
# where the curves separate: range-guarded weights hold their divergence
# under the budget while recurrent state — whose legal-float exponent
# flips pass the NaN/Inf detector and compound through the recurrence —
# collapses to full divergence
_REFRESH_POINTS = (0.256, 1.0, 2.0, 4.0)


@dataclasses.dataclass(frozen=True)
class AutopilotPreset:
    """One profilable model: tiny architecture + campaign recipe + budget."""

    name: str
    arch: ArchConfig
    campaign: Any                   # autopilot.campaign.CampaignConfig
    budget: float                   # quality budget handed to solve_frontier

    def build_model(self, *, device=None):
        """The preset's model with random weights from the campaign's seed
        (the reference's ``model.init(PRNGKey(seed))``), on the card unless
        ``device`` says otherwise."""
        from ..models import build_model

        return build_model(self.arch, device=device, seed=self.campaign.seed)


def _tiny(name: str, **overrides) -> ArchConfig:
    return dataclasses.replace(
        get_config(name).reduced(),
        repair=ApproxConfig(mode="off"),
        **overrides,
    )


def transformer_preset(steps: int = 8, seed: int = 0) -> AutopilotPreset:
    """Dense transformer: FFN weights vs the KV cache."""
    from ..autopilot.campaign import CampaignConfig, RegionGroup

    arch = _tiny(
        "qwen2-1.5b",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=97,
    )
    groups = (
        RegionGroup(
            name="ffn_weights", pattern=r"params/layers/mlp/",
            rule=_WEIGHT_RULE,
        ),
        # the alternation binds one rule to BOTH path renderings of the KV
        # cache: the serve-state tree (cache/layers/{k,v}) the campaign
        # profiles, and the engine's paged-pool tree (layers/{k,v}) the
        # frontier's RuleSet is deployed onto — so the online guard's
        # per-label counters stay keyed to the profiled group in serving
        RegionGroup(name="kv_cache", pattern=r"cache/|layers/(k|v)$"),
    )
    return AutopilotPreset(
        name="transformer",
        arch=arch,
        campaign=CampaignConfig(
            groups=groups, refresh_points=_REFRESH_POINTS,
            episode="serve", steps=steps, seed=seed,
        ),
        budget=0.3,
    )


def recurrent_preset(steps: int = 8, seed: int = 0) -> AutopilotPreset:
    """xLSTM: projection weights vs the recurrent mLSTM/sLSTM state."""
    from ..autopilot.campaign import CampaignConfig, RegionGroup

    arch = _tiny(
        "xlstm-1.3b",
        n_layers=2, slstm_every=2, vocab=97,
    )
    groups = (
        RegionGroup(
            name="proj_weights", pattern=r"params/.*/w_(up|down)",
            rule=_WEIGHT_RULE,
        ),
        RegionGroup(name="recurrent_state", pattern=r"cache/"),
    )
    return AutopilotPreset(
        name="recurrent",
        arch=arch,
        campaign=CampaignConfig(
            groups=groups, refresh_points=_REFRESH_POINTS,
            episode="serve", steps=steps, seed=seed,
        ),
        budget=0.3,
    )


PRESETS = {
    "transformer": transformer_preset,
    "recurrent": recurrent_preset,
}


def preset_names():
    return list(PRESETS)


def get_preset(name: str, **kwargs) -> AutopilotPreset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(PRESETS)}")
    return PRESETS[name](**kwargs)
