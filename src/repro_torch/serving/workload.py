"""Production-shaped serving workloads: seed-deterministic arrival traces.

A traffic harness replays an *arrival trace* against a live engine —
Poisson arrivals at a configurable rate, a mixed short/long prompt-length
population, per-request output budgets, and an optional burst (every
burst request lands on the same step, the preemption-storm shape).

Everything is derived from ONE ``numpy`` generator seeded by
``WorkloadConfig.seed``: regenerating from the same config yields the
identical trace, bit for bit, so two engines (sharded vs single-device,
desynchronized vs lockstep) can replay the same traffic and be compared
token-for-token.  No clock anywhere — "time" is the engine step index.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of the trace: lands at engine step ``step``."""

    step: int
    prompt: Tuple[int, ...]
    max_new: int


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Shape of the synthetic traffic.

    n_requests       trace length (burst arrivals come on top)
    arrival_rate     mean arrivals per engine step (Poisson process:
                     exponential inter-arrival gaps, floored to steps)
    prompt_len       inclusive (lo, hi) token-count range of short prompts
    long_prompt_len  inclusive range of the long-prompt population
    long_frac        fraction of prompts drawn from the long range — the
                     bimodal prompt mix that makes chunked prefill and
                     admission control actually work for a living
    output_len       inclusive (lo, hi) range of per-request ``max_new``
    vocab            token ids are drawn uniformly from [1, vocab)
    burst_at         step at which ``burst_n`` extra arrivals land at once
                     (-1 disables) — the preemption-storm knob
    burst_n          size of the burst
    seed             the one generator seed everything derives from
    """

    n_requests: int = 32
    arrival_rate: float = 1.0
    prompt_len: Tuple[int, int] = (2, 16)
    long_prompt_len: Tuple[int, int] = (24, 48)
    long_frac: float = 0.0
    output_len: Tuple[int, int] = (4, 24)
    vocab: int = 97
    burst_at: int = -1
    burst_n: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1 ({self.n_requests})")
        if self.arrival_rate <= 0.0:
            raise ValueError(
                f"arrival_rate must be > 0 ({self.arrival_rate})"
            )
        for name in ("prompt_len", "long_prompt_len", "output_len"):
            lo, hi = getattr(self, name)
            if not 1 <= lo <= hi:
                raise ValueError(f"bad {name} range ({lo}, {hi})")
        if not 0.0 <= self.long_frac <= 1.0:
            raise ValueError(f"long_frac must lie in [0, 1] ({self.long_frac})")
        if self.vocab < 2:
            raise ValueError(f"vocab must be >= 2 ({self.vocab})")
        if self.burst_n < 0:
            raise ValueError(f"burst_n must be >= 0 ({self.burst_n})")


def _draw_request(rng: np.random.Generator, cfg: WorkloadConfig, step: int
                  ) -> Arrival:
    lo, hi = (
        cfg.long_prompt_len
        if cfg.long_frac > 0.0 and rng.random() < cfg.long_frac
        else cfg.prompt_len
    )
    n = int(rng.integers(lo, hi + 1))
    prompt = tuple(int(t) for t in rng.integers(1, cfg.vocab, size=n))
    max_new = int(rng.integers(cfg.output_len[0], cfg.output_len[1] + 1))
    return Arrival(step=step, prompt=prompt, max_new=max_new)


def generate_arrivals(cfg: WorkloadConfig) -> List[Arrival]:
    """The trace, sorted by step.  Deterministic in ``cfg`` alone: one
    ``default_rng(cfg.seed)`` drives inter-arrival gaps and request shapes
    in a fixed draw order, so equal configs give bit-equal traces."""
    rng = np.random.default_rng(cfg.seed)
    arrivals: List[Arrival] = []
    t = 0.0
    for _ in range(cfg.n_requests):
        t += rng.exponential(1.0 / cfg.arrival_rate)
        arrivals.append(_draw_request(rng, cfg, int(t)))
    if cfg.burst_at >= 0 and cfg.burst_n > 0:
        for _ in range(cfg.burst_n):
            arrivals.append(_draw_request(rng, cfg, cfg.burst_at))
    arrivals.sort(key=lambda a: a.step)     # stable: burst order preserved
    return arrivals
