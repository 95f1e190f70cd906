"""Approximate-memory region annotation.

State is a flat dict ``{path: tensor}`` whose keys are the ``a/b/c`` path
renderings the reference matches its rules against (for the KV pool:
``layers/k`` and ``layers/v``), so region and repair rules carry over from
the JAX package unchanged.
"""
from __future__ import annotations

import enum
import re
from typing import Any, Dict, Mapping, Sequence, Tuple


class Region(enum.Enum):
    EXACT = "exact"
    APPROX = "approx"


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested dict as ``{"a/b/c": leaf}``, keys sorted at every level
    (the reference's leaf order)."""
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


# Ordered (pattern, region) rules; first match wins.  Control-plane scalars
# are pinned exact; everything else (weights, KV pages) is approximate.
DEFAULT_RULES: Tuple[Tuple[str, Region], ...] = (
    (r"(^|/)(step|count|counter|schedule|loss_scale)($|/)", Region.EXACT),
    (r"(^|/)[^/]*(rng|key)[^/]*($|/)", Region.EXACT),
    (r"(^|/)router($|/)|gate_table", Region.EXACT),
    (r".*", Region.APPROX),
)


def classify(path: str, rules: Sequence[Tuple[str, Region]] = DEFAULT_RULES):
    for pattern, region in rules:
        if re.search(pattern, path):
            return region
    return Region.APPROX


def annotate(
    tree: Mapping[str, Any], rules: Sequence[Tuple[str, Region]] = DEFAULT_RULES
) -> Dict[str, Region]:
    """``{path: Region}`` for a flat state dict."""
    return {path: classify(path, rules) for path in tree}


def approx_mask(tree: Mapping[str, Any],
                regions: Mapping[str, Region]) -> Dict[str, bool]:
    """``{path: bool}``: True where the leaf is in approximate memory
    (``regions`` is ``annotate``'s flat mapping)."""
    return {path: r is Region.APPROX for path, r in regions.items()}


def count_bytes(tree: Mapping[str, Any],
                regions: Mapping[str, Region]) -> Tuple[int, int]:
    """(approx_bytes, exact_bytes) of a flat state dict under ``{path:
    Region}``: the energy model's split (savings apply only to the
    approximate bytes).  Every tensor or array counts, whatever its dtype."""
    approx = exact = 0
    for path, leaf in tree.items():
        nbytes = int(getattr(leaf, "nbytes", 0))
        if regions[path] is Region.APPROX:
            approx += nbytes
        else:
            exact += nbytes
    return approx, exact
