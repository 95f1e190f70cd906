"""Profiling campaign: per-region error-tolerance curves (reference
``autopilot/campaign.py``, EDEN's measurement step).

  RegionGroup        one named data-structure class: a path regex over the
                     flat state (the ``RuleSet`` binding grammar) and the
                     repair rule the group deploys with while approximate
  CampaignConfig     the sweep: groups × refresh points, the episode kind
                     (short injected serve or train runs), their lengths
                     and the seed every draw derives from
  ProfileCell        one (group, refresh point) measurement: the BER and
                     energy saving of ``ApproxMemoryModel.from_refresh``,
                     the quality metric, the flips and the group rule's
                     fatal detections a step (the guard's expectation)
  ToleranceProfile   the grid, in the reference's JSON

Each cell runs one episode with its flips confined to ONE group:
``ApproxSpace.inject(..., regions=mask)`` with every leaf outside the
group's pattern pinned EXACT.  Each window is followed by a boundary scrub
under the campaign's rules (the groups' own rules, labeled by group, so
``rule_stats()`` separates their counters), then the production step
runs.  Quality is graded against a clean episode with the same prompts and
batches: serve episodes decode token by token, teacher-forced on the clean
run, and count the next-token predictions that differ
(``token_divergence``); train episodes take the mean loss of the second
half minus the clean run's (``loss_delta``).

The resident is flat: ``params/<path>`` (the model's own tensors,
``param_tree``) and ``cache/<path>`` for serve episodes, ``params/...``
and ``opt/...`` for train episodes, so the reference's group patterns
match as they do there.  The port's weights are the model's tensors and
injection and scrub write them in place, so ``run_campaign`` snapshots
the weights once and copies them back before every episode (and at the
end); every train episode starts from that snapshot with zero moments and
step 0.  Draws come from ``torch.Generator``s seeded from the reference's
integers: prompts from ``seed + 7``, train batches from ``(seed + 11,
step)``, a window's flips from ``(seed, group, point, step)``; the flips
themselves cannot be the reference's, only their statistics, and a
repeated campaign is identical.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import regions as regions_lib
from ..core.injection import ApproxMemoryModel
from ..core.rules import Detector, RepairRule, RuleSet
from ..launch.serve import build_serve_step
from ..launch.train import build_train_step, init_train_state, make_optimizer
from ..runtime import ApproxConfig, ApproxSpace, ScrubSchedule

__all__ = [
    "RegionGroup", "CampaignConfig", "ProfileCell", "ToleranceProfile",
    "campaign_space", "group_regions", "run_campaign",
    "rule_to_json", "rule_from_json",
]

_EPISODES = ("serve", "train")
_METRICS = {"serve": "token_divergence", "train": "loss_delta"}

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Rule (de)serialization: the profile's JSON.
# ---------------------------------------------------------------------------


def rule_to_json(rule: RepairRule) -> Dict[str, Any]:
    """JSON-able dict for a ``RepairRule`` (str/float fills only: a
    callable fill has no stable serialization and raises)."""
    fill = rule.fill
    if not isinstance(fill, (str, int, float)):
        raise TypeError(
            f"only str/float fills serialize to JSON, got {type(fill).__name__}"
        )
    return {
        "detect": {
            "nan": rule.detect.nan,
            "inf": rule.detect.inf,
            "max_magnitude": rule.detect.max_magnitude,
            "bitpatterns": [list(bp) for bp in rule.detect.bitpatterns],
        },
        "fill": fill,
        "trigger": rule.trigger,
        "exact": rule.exact,
        "label": rule.label,
    }


def rule_from_json(d: Dict[str, Any]) -> RepairRule:
    det = d["detect"]
    return RepairRule(
        detect=Detector(
            nan=bool(det["nan"]),
            inf=bool(det["inf"]),
            max_magnitude=det["max_magnitude"],
            bitpatterns=tuple(tuple(bp) for bp in det["bitpatterns"]),
        ),
        fill=d["fill"],
        trigger=d["trigger"],
        exact=bool(d["exact"]),
        label=d["label"],
    )


# ---------------------------------------------------------------------------
# The campaign surface.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RegionGroup:
    """One named data-structure class: a path regex and the rule the group
    deploys with while approximate.  The default rule is the serving
    posture (NaN/Inf only, zero fill); weight groups typically pass the
    training rule (``neighbor_mean`` with a range guard)."""

    name: str
    pattern: str
    rule: RepairRule = RepairRule(
        detect=Detector(nan=True, inf=True), fill="zero", trigger="boundary"
    )

    def labeled_rule(self) -> RepairRule:
        """The deployed rule labeled with the group's name: per-rule
        counters and guard expectations key on it."""
        return dataclasses.replace(self.rule, label=self.name)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "pattern": self.pattern,
            "rule": rule_to_json(self.rule),
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "RegionGroup":
        return RegionGroup(
            name=d["name"], pattern=d["pattern"], rule=rule_from_json(d["rule"]),
        )


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """The sweep: ``groups`` × ``refresh_points``, measured with ``episode``
    runs of ``steps`` production steps each."""

    groups: Tuple[RegionGroup, ...]
    refresh_points: Tuple[float, ...]
    episode: str = "serve"          # "serve" | "train"
    steps: int = 12
    batch: int = 2
    prompt_len: int = 8             # serve episodes: greedy-decoded prompt
    seq_len: int = 16               # train episodes: tokens per batch row
    seed: int = 0

    def __post_init__(self):
        if self.episode not in _EPISODES:
            raise ValueError(
                f"bad episode {self.episode!r}; expected one of {_EPISODES}"
            )
        if not self.groups:
            raise ValueError("a campaign needs at least one RegionGroup")
        if not self.refresh_points:
            raise ValueError("a campaign needs at least one refresh point")
        names = [g.name for g in self.groups]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate group names: {names}")
        if self.steps < 2:
            raise ValueError("episodes need at least 2 steps")


@dataclasses.dataclass(frozen=True)
class ProfileCell:
    """One (group, refresh point) measurement."""

    group: str
    refresh_s: float
    ber: float
    energy_saving: float            # refresh model's saving at this point
    quality: float                  # token_divergence | loss_delta
    flips: int                      # injected bit flips
    faults_per_step: float          # group-rule fatal detections / step
    approx_bytes: int               # bytes the group's mask exposes


@dataclasses.dataclass(frozen=True)
class ToleranceProfile:
    """The campaign's grid, in the reference's JSON (either package loads
    the other's)."""

    model: str
    episode: str
    metric: str
    steps: int
    seed: int
    groups: Tuple[RegionGroup, ...]
    refresh_points: Tuple[float, ...]
    cells: Tuple[ProfileCell, ...]

    def group_cells(self, name: str) -> Tuple[ProfileCell, ...]:
        return tuple(c for c in self.cells if c.group == name)

    def cell(self, name: str, refresh_s: float) -> ProfileCell:
        for c in self.cells:
            if c.group == name and c.refresh_s == refresh_s:
                return c
        raise KeyError(f"no cell for group {name!r} at refresh {refresh_s}")

    def to_json(self) -> str:
        return json.dumps({
            "model": self.model,
            "episode": self.episode,
            "metric": self.metric,
            "steps": self.steps,
            "seed": self.seed,
            "groups": [g.to_json() for g in self.groups],
            "refresh_points": list(self.refresh_points),
            "cells": [dataclasses.asdict(c) for c in self.cells],
        }, indent=2)

    @staticmethod
    def from_json(text: str) -> "ToleranceProfile":
        d = json.loads(text)
        return ToleranceProfile(
            model=d["model"],
            episode=d["episode"],
            metric=d["metric"],
            steps=d["steps"],
            seed=d["seed"],
            groups=tuple(RegionGroup.from_json(g) for g in d["groups"]),
            refresh_points=tuple(d["refresh_points"]),
            cells=tuple(ProfileCell(**c) for c in d["cells"]),
        )


# ---------------------------------------------------------------------------
# Campaign runtime pieces.
# ---------------------------------------------------------------------------


def campaign_space(groups: Tuple[RegionGroup, ...]) -> ApproxSpace:
    """The campaign's runtime: memory mode, the groups' deployed rules bound
    in group order (labels = group names, so ``rule_stats()`` separates
    the groups' counters) and no boundary schedule: the episode loop
    scrubs between injection and compute."""
    entries = tuple((g.pattern, g.labeled_rule()) for g in groups)
    return ApproxSpace(ApproxConfig(
        mode="memory",
        rules=RuleSet(entries),
        scrub=ScrubSchedule(boundary=False),
    ))


def group_regions(space: ApproxSpace, tree: Tree,
                  pattern: str) -> Dict[str, regions_lib.Region]:
    """The mask confining one injection window to the group: leaves whose
    path matches ``pattern`` keep the space's region, every other leaf is
    pinned EXACT (never flipped)."""
    rx = re.compile(pattern)
    return {
        path: region if rx.search(path) else regions_lib.Region.EXACT
        for path, region in space.regions_for(tree).items()
    }


def _group_faults(space: ApproxSpace, name: str) -> int:
    """Cumulative fatal detections (nan + inf) charged to the group's rule."""
    row = space.rule_stats().get(name)
    return 0 if row is None else row["nan_found"] + row["inf_found"]


def _generator(device: torch.device, *ints: int) -> torch.Generator:
    """A generator on ``device`` seeded from the reference's integers."""
    seed = 0
    for x in ints:
        seed = (seed * 1_000_003 + int(x)) % (1 << 62)
    return torch.Generator(device=device).manual_seed(seed)


def _prompts(cfg: CampaignConfig, vocab: int, device) -> torch.Tensor:
    """The serve episodes' prompts, (batch, prompt_len) in [1, vocab)."""
    return torch.randint(1, vocab, (cfg.batch, cfg.prompt_len),
                         generator=_generator(device, cfg.seed + 7),
                         device=device)


def _train_batch(cfg: CampaignConfig, vocab: int, step: int,
                 device) -> Dict[str, torch.Tensor]:
    """The train episodes' batch at ``step``: (batch, seq_len) tokens."""
    return {"tokens": torch.randint(
        1, vocab, (cfg.batch, cfg.seq_len),
        generator=_generator(device, cfg.seed + 11, step), device=device)}


def _inject_and_scrub(space: ApproxSpace, resident: Tree, regions,
                      ber: float, generator: torch.Generator) -> int:
    """One deployment cycle prefix, in place: a masked injection window,
    then the boundary scrub under the campaign rules.  Returns the
    window's flips."""
    _, flips = space.inject(resident, generator, ber, record=False,
                            regions=regions)
    space.scrub(resident, trigger="boundary")
    return int(flips)


def _masked(space, resident, pattern):
    """(mask, approx bytes it exposes); ``(None, 0)`` for the clean run."""
    if pattern is None:
        return None, 0
    masked = group_regions(space, resident, pattern)
    return masked, regions_lib.count_bytes(resident, masked)[0]


# ---------------------------------------------------------------------------
# Episodes.
# ---------------------------------------------------------------------------


@torch.no_grad()
def _serve_episode(
    model: Any,
    space: ApproxSpace,
    cfg: CampaignConfig,
    pattern: Optional[str],
    ber: float,
    ep_key: Tuple[int, ...],
    force: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, int, int]:
    """One greedy serve episode, token by token.  Returns (emitted tokens
    [steps, batch], total flips, group approx bytes); ``pattern=None`` is
    the clean run.  With ``force`` (the clean run's emitted tokens) the
    decode is teacher-forced on the clean trajectory, so a position counts
    only if the faults changed its own prediction."""
    dev = model.device
    prompts = _prompts(cfg, model.cfg.vocab, dev)
    cache = model.init_cache(cfg.batch, cfg.prompt_len + cfg.steps + 1)
    step_fn = build_serve_step(model)
    resident = {f"params/{p}": t for p, t in model.param_tree().items()}
    resident.update({f"cache/{p}": t for p, t in cache.items()})
    masked, approx_bytes = _masked(space, resident, pattern)
    flips_total = 0
    emitted: List[np.ndarray] = []
    S0 = cfg.prompt_len
    nxt = prompts[:, :1]
    for t in range(S0 + cfg.steps - 1):
        if t < S0:
            tok = prompts[:, t:t + 1]
        elif force is not None:
            tok = torch.as_tensor(force[t - S0], dtype=torch.int64,
                                  device=dev)[:, None]
        else:
            tok = nxt
        if masked is not None and ber > 0.0:
            flips_total += _inject_and_scrub(
                space, resident, masked, ber, _generator(dev, *ep_key, t))
        nxt_flat, _, cache = step_fn(cache, tok, t)
        nxt = nxt_flat[:, None].to(torch.int64)
        if t >= S0 - 1:
            emitted.append(nxt_flat.cpu().numpy())
    return np.stack(emitted), flips_total, approx_bytes


def _train_episode(
    model: Any,
    space: ApproxSpace,
    cfg: CampaignConfig,
    pattern: Optional[str],
    ber: float,
    ep_key: Tuple[int, ...],
) -> Tuple[np.ndarray, int, int]:
    """One injected train episode from the model's weights as they stand
    (the campaign's snapshot), zero moments and step 0.  Returns (per-step
    losses, total flips, group approx bytes); ``pattern=None`` is the
    clean run.  The step runs raw (``ApproxSpace(mode="off")``): the
    campaign scrubs between steps."""
    dev = model.device
    opt = make_optimizer(warmup=2, total=cfg.steps)
    state = init_train_state(model, opt)
    step_fn = build_train_step(model, opt, space=ApproxSpace(mode="off"))
    resident = {p: t for p, t in state.items()
                if p.startswith(("params/", "opt/"))}
    masked, approx_bytes = _masked(space, resident, pattern)
    flips_total = 0
    losses: List[float] = []
    for i in range(cfg.steps):
        if masked is not None and ber > 0.0:
            flips_total += _inject_and_scrub(
                space, resident, masked, ber, _generator(dev, *ep_key, i))
        state, metrics = step_fn(state, _train_batch(cfg, model.cfg.vocab, i, dev))
        losses.append(float(metrics["loss"]))
    return np.asarray(losses), flips_total, approx_bytes


# ---------------------------------------------------------------------------
# The campaign loop.
# ---------------------------------------------------------------------------


def run_campaign(
    model: Any,
    cfg: CampaignConfig,
    params: Optional[Tree] = None,
) -> ToleranceProfile:
    """Sweep ``cfg.groups`` × ``cfg.refresh_points`` and return the measured
    ``ToleranceProfile``.  ``params`` (``{path: tensor}``, ``param_tree``'s
    paths) is copied into the model's tensors first; without it the
    model's weights as they stand are profiled.  The weights are restored
    before every episode and left as they were found."""
    space = campaign_space(cfg.groups)
    own = model.param_tree()
    with torch.no_grad():
        if params is not None:
            for path, t in own.items():
                t.copy_(torch.as_tensor(params[path]).to(t.device, t.dtype))
        snapshot = {p: t.clone() for p, t in own.items()}

    def episode(pattern, ber, ep_key, force=None):
        with torch.no_grad():
            for p, t in own.items():
                t.copy_(snapshot[p])
        if cfg.episode == "serve":
            return _serve_episode(model, space, cfg, pattern, ber, ep_key,
                                  force=force)
        return _train_episode(model, space, cfg, pattern, ber, ep_key)

    try:
        clean, _, _ = episode(None, 0.0, (0,))
        half = cfg.steps // 2
        cells: List[ProfileCell] = []
        for gi, group in enumerate(cfg.groups):
            for pi, refresh_s in enumerate(cfg.refresh_points):
                mm = ApproxMemoryModel.from_refresh(refresh_s)
                faults0 = _group_faults(space, group.name)
                out, flips, nbytes = episode(group.pattern, mm.ber,
                                             (cfg.seed, gi, pi), force=clean)
                if cfg.episode == "serve":
                    quality = float(np.mean(out != clean))
                else:
                    quality = float(np.mean(out[half:]) - np.mean(clean[half:]))
                faults = _group_faults(space, group.name) - faults0
                cells.append(ProfileCell(
                    group=group.name,
                    refresh_s=float(refresh_s),
                    ber=float(mm.ber),
                    energy_saving=float(mm.energy_saving),
                    quality=quality,
                    flips=int(flips),
                    faults_per_step=faults / float(cfg.steps),
                    approx_bytes=int(nbytes),
                ))
    finally:
        with torch.no_grad():
            for p, t in own.items():
                t.copy_(snapshot[p])

    return ToleranceProfile(
        model=str(getattr(model.cfg, "name", type(model).__name__)),
        episode=cfg.episode,
        metric=_METRICS[cfg.episode],
        steps=cfg.steps,
        seed=cfg.seed,
        groups=cfg.groups,
        refresh_points=tuple(float(r) for r in cfg.refresh_points),
        cells=tuple(cells),
    )
