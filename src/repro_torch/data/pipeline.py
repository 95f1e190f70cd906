"""Stateless-seeded synthetic data (reference ``data/pipeline.py``).

The batch for step ``i`` is a pure function of ``(seed, i)``: a restarted
job resumes at its step with no data state to replay.  Tokens are
Zipf-ish (an exponential rank clamped to the vocabulary) with local n-gram
structure (with probability 1/2 a token repeats its left neighbour's
neighbourhood), so the loss goes down.

The draws come from an explicit ``torch.Generator`` on the CPU, seeded
from ``(seed, step)``, and the batch is then moved to the device, so the
card and the CPU get the same tokens.  Its bits cannot equal the
reference's threefry stream: tests that hold the port against the
reference feed it the reference's batches as numpy.  A patch-prefix
config (``frontend == "patches"``, LLaVA) gets ``int(seq ·
frontend_fraction)`` rows of standard-normal ``patch_embeds`` in its
dtype before ``seq - P`` tokens, drawn from a generator of their own; the
audio family's frame batches are not ported.

``host_slice`` carves the global batch by process index, the multi-host
arithmetic of the reference (one process here).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import device as device_lib
from ..configs.base import ArchConfig

_SALT = 0x7E4
_PATCH_SALT = 0xF1


def _generator(seed: int, step: int, salt: int = _SALT) -> torch.Generator:
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9
             + salt) % (1 << 63)
    return torch.Generator(device="cpu").manual_seed(mixed)


def _tokens_for_step(seed: int, step: int, batch: int, seq: int,
                     vocab: int) -> torch.Tensor:
    """Zipf-ish int32 tokens (batch, seq) with n-gram structure, on the
    CPU, deterministic in (seed, step)."""
    gen = _generator(seed, step)
    r = torch.empty(batch, seq).exponential_(generator=gen) * (vocab / 8.0)
    base = r.clamp(max=vocab - 1).to(torch.int32)
    rep = torch.rand(batch, seq, generator=gen) < 0.5
    shift = torch.randint(-2, 3, (batch, seq), generator=gen,
                          dtype=torch.int32)
    prev = torch.roll(base, 1, dims=1)
    structured = (prev + shift).clamp(0, vocab - 1)
    return torch.where(rep, structured, base)


def batch_for_step(cfg: ArchConfig, seed: int, step: int, *, batch: int,
                   seq: int, device=None) -> Dict[str, torch.Tensor]:
    """The global batch of one training step, ``{"tokens": (batch, seq)
    int32}`` on ``device`` (the card unless the caller asks for the CPU);
    a patch-prefix config's is ``{"tokens": (batch, seq - P),
    "patch_embeds": (batch, P, d_model) cfg.dtype}``, ``P = int(seq ·
    frontend_fraction)``."""
    if cfg.family == "audio":
        raise NotImplementedError(
            "the audio frame batches are not ported: ROADMAP slice 5 (the "
            "other families)"
        )
    dev = device_lib.resolve(device)
    if cfg.frontend == "patches":
        P = int(seq * cfg.frontend_fraction)
        tokens = _tokens_for_step(seed, int(step), batch, seq - P, cfg.vocab)
        gen = _generator(seed, int(step), _PATCH_SALT)
        patches = torch.randn(batch, P, cfg.d_model, generator=gen)
        return {"tokens": tokens.to(dev),
                "patch_embeds": patches.to(cfg.dtype).to(dev)}
    tokens = _tokens_for_step(seed, int(step), batch, seq, cfg.vocab)
    return {"tokens": tokens.to(dev)}


@dataclasses.dataclass(frozen=True)
class SyntheticStream:
    """Callable over steps: ``stream(step)`` is that step's batch, this
    process's slice of it when there are several processes."""

    cfg: ArchConfig
    seed: int
    batch: int
    seq: int
    process_index: int = 0
    process_count: int = 1
    device: Optional[object] = None

    def __post_init__(self):
        if self.batch % self.process_count:
            raise ValueError(
                f"global batch {self.batch} must divide across "
                f"{self.process_count} processes"
            )

    @property
    def host_batch(self) -> int:
        return self.batch // self.process_count

    def host_slice(self, global_batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        lo = self.process_index * self.host_batch
        return {k: v[lo:lo + self.host_batch] for k, v in global_batch.items()}

    def __call__(self, step) -> Dict[str, torch.Tensor]:
        g = batch_for_step(self.cfg, self.seed, step, batch=self.batch,
                           seq=self.seq, device=self.device)
        if self.process_count == 1:
            return g
        return self.host_slice(g)
