"""``last_checkpoint`` repair policy: repair NaNs from checkpoint leaves.

The strongest answer to the paper's open question (§5.2, "values to which
NaNs are fixed"): at framework scale there is a recent good value for every
protected buffer, the latest checkpoint.  Repairing a flipped weight from
its checkpointed value restores it exactly, up to one checkpoint interval of
optimizer drift; for inference (frozen weights) it is exact.

.. deprecated::
    The implementation lives in ``repro_torch.runtime``: the reference
    scrub is the "reference" scope of ``runtime.plan.RepairPlan``, and its
    entry point is ``ApproxSpace.scrub_with_reference``
    (``CheckpointManager.restore`` and ``reference_repair`` call it).  This
    module is a thin shim kept for source compatibility and emits a
    ``DeprecationWarning`` on every call.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import torch

from . import regions as regions_lib, rules as rules_lib, stats as stats_lib


def scrub_with_reference(
    tree: Dict[str, torch.Tensor],
    ref_tree: Dict[str, torch.Tensor],
    stats: stats_lib.Stats,
    region_tree: Optional[Dict[str, regions_lib.Region]] = None,
    *,
    include_inf: bool = True,
) -> Tuple[Dict[str, torch.Tensor], stats_lib.Stats]:
    """Replace the fatal lanes of the approximate-region leaves of the flat
    state ``tree`` with the values of ``ref_tree`` (the same paths, e.g. the
    last checkpoint), in place.

    Deprecated shim: the reference scope's per-leaf repair
    (``runtime.plan.reference_leaf``) under one NaN(/Inf) rule, not gated
    on the repair mode (a reference repair is an explicit request).
    """
    from ..runtime import plan as plan_lib  # deferred: runtime builds on core

    warnings.warn(
        "core.checkpoint_repair.scrub_with_reference is a deprecated shim; "
        "use runtime.ApproxSpace.scrub_with_reference",
        DeprecationWarning,
        stacklevel=2,
    )
    if region_tree is None:
        region_tree = regions_lib.annotate(tree)
    rule = rules_lib.RepairRule(detect=rules_lib.Detector(nan=True, inf=include_inf))
    counts = [
        plan_lib.reference_leaf(leaf, rule, ref_tree[p])
        for p, leaf in tree.items()
        if plan_lib.is_approx_float(leaf, region_tree[p]) and leaf.numel()
    ]
    nan = inf = 0
    if counts:
        nan, inf = torch.stack(counts).sum(0).tolist()
    return tree, stats_lib.record_repair(stats, nan, inf)
