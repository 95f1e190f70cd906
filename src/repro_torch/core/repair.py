"""Reactive NaN repair at the tensor level — the paper's two mechanisms
(§3.3 / §3.4):

* **register mode** (``use``): repair at the point of use, every use; the
  stored tensor keeps its NaN and each read pays a detect and select.
* **memory mode**: repair once and write back to memory, so later reads
  are clean (``runtime.ApproxSpace.scrub`` and the kernels' origin scrub
  in ``kernels.ops``).

``repair_tensor`` and ``fatal_masks`` are the primitives shared with the
runtime.  The state-level entry points here (``scrub_pytree``,
``inject_pytree``) are deprecated shims over ``runtime.ApproxSpace``'s
``scrub`` and ``inject`` that warn a ``DeprecationWarning`` on every call,
as the reference's do.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple, Union

import torch

from . import policies, regions as regions_lib, rules as rules_lib
from . import stats as stats_lib


def _deprecated(name: str, replacement: str) -> None:
    warnings.warn(
        f"core.repair.{name} is a deprecated shim; use {replacement} "
        "(README §Migration)",
        DeprecationWarning,
        stacklevel=3,
    )


@dataclasses.dataclass(frozen=True)
class RepairConfig:
    """The scalar repair switch.  ``max_magnitude``: also treat |x| >= this
    value as fatal (counted in the Inf bucket); None is paper-faithful."""

    mode: str = "memory"          # "off" | "register" | "memory"
    policy: Any = "neighbor_mean"  # name | float | RepairPolicy
    include_inf: bool = True
    max_magnitude: Optional[float] = None

    def resolved_policy(self) -> policies.RepairPolicy:
        return policies.get(self.policy)

    def __post_init__(self):
        if self.mode not in ("off", "register", "memory"):
            raise ValueError(f"bad repair mode {self.mode!r}")


def fatal_masks(
    x: torch.Tensor,
    *,
    include_inf: bool = True,
    max_magnitude: Optional[float] = None,
    detector: Optional[rules_lib.Detector] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nan_mask, inf_mask) of the fatal lanes of ``x``: ``detector``, or
    the one the scalar knobs lift into."""
    if detector is None:
        detector = rules_lib.Detector(
            nan=True, inf=include_inf, max_magnitude=max_magnitude
        )
    return detector.masks(x)


def repair_tensor(
    x: torch.Tensor,
    *,
    policy: policies.RepairPolicy,
    include_inf: bool = True,
    max_magnitude: Optional[float] = None,
    detector: Optional[rules_lib.Detector] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(repaired copy, nan_count, inf_count) of one tensor; non-fatal lanes
    are bit-identical to ``x``."""
    nan_m, inf_m = fatal_masks(
        x, include_inf=include_inf, max_magnitude=max_magnitude,
        detector=detector,
    )
    mask = nan_m | inf_m
    fixed = torch.where(mask, policy(x, mask), x)
    return fixed, nan_m.sum(), inf_m.sum()


def use(
    x: torch.Tensor,
    cfg: Any,
    stats: Optional[stats_lib.Stats] = None,
    path: str = "",
):
    """Register-mode read through ``runtime.use_tensor``: the repaired
    tensor (its counts not read back), or ``(repaired, stats')`` when
    ``stats`` is given.  ``cfg`` is a repair config or a prebuilt
    ``ApproxSpace``, whose config is then used as it stands."""
    from ..runtime import ApproxSpace  # deferred: runtime builds on core
    from ..runtime.space import use_tensor

    config = cfg.config if isinstance(cfg, ApproxSpace) else ApproxSpace(cfg).config
    fixed, stats = use_tensor(x, config, stats, path)
    return fixed if stats is None else (fixed, stats)


def scrub_pytree(
    tree: Dict[str, torch.Tensor],
    cfg: Any,
    stats: stats_lib.Stats,
    region_tree: Optional[Dict[str, regions_lib.Region]] = None,
) -> Tuple[Dict[str, torch.Tensor], stats_lib.Stats]:
    """Memory-mode repair of every approximate float leaf of the flat state
    ``tree``, in place: ``(tree, stats')``.  ``region_tree`` (``{path:
    Region}``) defaults to ``regions.annotate(tree)``.

    Deprecated shim: delegates to ``runtime.ApproxSpace.scrub``'s plan."""
    from ..runtime import ApproxSpace  # deferred: runtime builds on core

    _deprecated("scrub_pytree", "runtime.ApproxSpace.scrub")
    if region_tree is None:
        region_tree = regions_lib.annotate(tree)
    space = ApproxSpace(cfg)
    out, delta = space.plan_for(tree, scope="tree", regions=region_tree).run(tree)
    return out, stats_lib.merge(stats, delta)


def inject_pytree(
    tree: Dict[str, torch.Tensor],
    generator: Union[torch.Generator, int],
    ber: float,
    region_tree: Optional[Dict[str, regions_lib.Region]] = None,
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Simulation only: one window of bit flips over the approximate float
    leaves of the flat state ``tree``, in place, drawn from ``generator``
    (a ``torch.Generator``, or a seed for one on the state's device) where
    the reference takes a key.  Returns ``(tree, n_flips)``.

    Deprecated shim: delegates to ``runtime.ApproxSpace.inject``."""
    from ..runtime import ApproxSpace  # deferred: runtime builds on core

    _deprecated("inject_pytree", "runtime.ApproxSpace.inject")
    if region_tree is None:
        region_tree = regions_lib.annotate(tree)
    if not isinstance(generator, torch.Generator):
        device = next(iter(tree.values())).device if tree else "cpu"
        generator = torch.Generator(device=device).manual_seed(int(generator))
    return ApproxSpace().inject(tree, generator, ber, record=False,
                                regions=region_tree)
