"""Repair/flip event counters — the Table 3 analogue.

  flips      bits flipped by the injection simulator (ground truth)
  nan_found  NaN lanes detected at repair sites
  inf_found  ±Inf lanes detected at repair sites
  events     repair invocations that found ≥1 fatal lane (one trap)

The port keeps the counters as host integers: every producer (the scrub,
the kernels' counter vectors, injection) hands back a small count that the
caller reads once.
"""
from __future__ import annotations

from typing import Dict, Sequence

Stats = Dict[str, int]

_FIELDS = ("flips", "nan_found", "inf_found", "events")

# kernel counter layout (int32[8]) shared with the paged kernels: indices
# (0, 3) NaN lanes per operand, (1, 4) Inf lanes, 6 the tile-visit events
NAN_A, INF_A, EV_A, NAN_B, INF_B, EV_B, EV_TOTAL = range(7)


def zeros() -> Stats:
    return {f: 0 for f in _FIELDS}


def merge(a: Stats, b: Stats) -> Stats:
    return {f: int(a[f]) + int(b[f]) for f in _FIELDS}


def record_repair(s: Stats, nan_count, inf_count) -> Stats:
    nan_count, inf_count = int(nan_count), int(inf_count)
    return {
        "flips": s["flips"],
        "nan_found": s["nan_found"] + nan_count,
        "inf_found": s["inf_found"] + inf_count,
        "events": s["events"] + int(nan_count + inf_count > 0),
    }


def record_flips(s: Stats, n) -> Stats:
    out = dict(s)
    out["flips"] = s["flips"] + int(n)
    return out


def record_kernel_counts(s: Stats, counts: Sequence[int]) -> Stats:
    """Fold a kernel counter vector (int32[8]) into the stream: the tile-
    visit event total adds to ``events`` directly (one poisoned-tile visit
    is one trap)."""
    c = [int(v) for v in counts]
    return {
        "flips": s["flips"],
        "nan_found": s["nan_found"] + c[NAN_A] + c[NAN_B],
        "inf_found": s["inf_found"] + c[INF_A] + c[INF_B],
        "events": s["events"] + c[EV_TOTAL],
    }


def as_dict(s: Stats) -> Dict[str, int]:
    return {f: int(s[f]) for f in _FIELDS}
