"""`ServingConfig` — the knob surface of the continuous-batching engine.

Same fields, defaults and validation as the reference (``autopilot`` is
an ``AutopilotConfig`` that arms the engine's online guard, or ``None``).
Field meanings are documented on the reference's
``repro.serving.config.ServingConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

_REPAIR_MODES = ("page", "whole", "off")
_PAGED_DECODE = ("auto", "off")
_PAGED_PREFILL = ("auto", "off")
_SWAP_POLICIES = ("swap", "recompute")

# split-K auto heuristic: engage flash decoding once the block-table walk is
# at least this many pages wide
_SPLIT_K_MIN_PAGES = 8


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    page_size: int = 16
    n_pages: int = 64
    max_batch: int = 8
    max_pages_per_request: int = 8

    repair: str = "page"
    sweep_interval: int = 0
    sweep_pages: int = 4
    paged_decode: str = "auto"
    paged_prefill: str = "auto"
    prefill_chunk: int = 0
    split_k: int = 0
    drain_interval: int = 0

    prefix_cache: bool = False
    max_cached_pages: int = 0
    dwell_threshold: float = 1.0

    host_pages: int = 0
    swap_policy: str = "swap"

    ber: float = 0.0
    seed: int = 0

    autopilot: Optional[Any] = None

    def __post_init__(self):
        if self.repair not in _REPAIR_MODES:
            raise ValueError(f"bad repair granularity {self.repair!r}")
        if self.paged_decode not in _PAGED_DECODE:
            raise ValueError(f"bad paged_decode mode {self.paged_decode!r}")
        if self.paged_prefill not in _PAGED_PREFILL:
            raise ValueError(f"bad paged_prefill mode {self.paged_prefill!r}")
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0 ({self.prefill_chunk})")
        if self.split_k < 0:
            raise ValueError(f"split_k must be >= 0 ({self.split_k})")
        if self.drain_interval < 0:
            raise ValueError(f"drain_interval must be >= 0 ({self.drain_interval})")
        if self.page_size < 1 or self.n_pages < 1:
            raise ValueError("page_size and n_pages must be >= 1")
        if self.max_pages_per_request > self.n_pages:
            raise ValueError(
                "max_pages_per_request must not exceed n_pages "
                f"({self.max_pages_per_request} > {self.n_pages})"
            )
        if self.swap_policy not in _SWAP_POLICIES:
            raise ValueError(f"bad swap_policy {self.swap_policy!r}")
        if self.host_pages < 0:
            raise ValueError(f"host_pages must be >= 0 ({self.host_pages})")
        if self.max_cached_pages < 0 or self.max_cached_pages > self.n_pages:
            raise ValueError(
                "max_cached_pages must lie in [0, n_pages] "
                f"({self.max_cached_pages} vs {self.n_pages})"
            )

    @property
    def max_seq(self) -> int:
        return self.page_size * self.max_pages_per_request

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def resolve_split_k(self) -> int:
        """Grid splits for the decode page walk: a divisor of the block-
        table width (every slot is walked exactly once)."""
        M = self.max_pages_per_request
        if self.split_k == 1:
            return 1
        if self.split_k > 1:
            want = min(self.split_k, M)
        elif M < _SPLIT_K_MIN_PAGES:
            return 1
        else:
            want = M // 2
        return max(d for d in range(1, want + 1) if M % d == 0)
