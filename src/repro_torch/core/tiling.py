"""The tile fit that defines the scrub's tile-visit events.

The reference's scrub counts one event per (block_rows, block_cols) tile
with a fatal lane, on the grid this fit picks.  The CUDA scrub keeps that
logical grid for counting whatever physical work split it uses, so the
counts stay identical to the reference's.
"""
from __future__ import annotations

from typing import Tuple

# Default caps: row dim ≤ 256, column dim ≤ 512.
TILE_ROWS, TILE_COLS = 256, 512


def fit(dim: int, cap: int) -> int:
    """Largest divisor of ``dim`` that is ≤ ``cap``, found by halving from
    ``min(dim, cap)``; never below 1 (zero-size dims fit the unit tile)."""
    if dim <= 0:
        return 1
    b = min(dim, cap)
    while dim % b:
        b //= 2
    return max(b, 1)


def fit_blocks(rows: int, cols: int) -> Tuple[int, int]:
    """(block_rows, block_cols) for a 2-D view under the default caps."""
    return fit(rows, TILE_ROWS), fit(cols, TILE_COLS)
