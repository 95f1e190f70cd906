"""Ported model families; ``build_model`` picks one by ``cfg.family``."""
from __future__ import annotations

from ..configs.base import ArchConfig
from .transformer_lm import TransformerLM  # noqa: F401
from .xlstm_lm import XLSTMLM  # noqa: F401
from .zamba import ZambaLM  # noqa: F401


def build_model(cfg: ArchConfig, *, device=None, seed: int = 0):
    """The model for ``cfg`` with random weights from ``seed``, on the card
    unless ``device`` says otherwise."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg, device=device, seed=seed)
    if cfg.family == "ssm":
        return XLSTMLM(cfg, device=device, seed=seed)
    if cfg.family == "hybrid":
        return ZambaLM(cfg, device=device, seed=seed)
    if cfg.family == "audio":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported: ROADMAP slice 5 (the other "
            "families)"
        )
    raise ValueError(f"unknown family {cfg.family!r}")
