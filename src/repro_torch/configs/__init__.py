"""Config registry of the ported architectures."""
from __future__ import annotations

from . import (
    llava_next_mistral_7b,
    mistral_large_123b,
    phi35_moe_42b,
    qwen2_1_5b,
    qwen3_moe_30b,
    stablelm_1_6b,
    starcoder2_15b,
    xlstm_1_3b,
    zamba2_7b,
)
from .base import ArchConfig  # noqa: F401

_CONFIGS = {m.CONFIG.name: m.CONFIG for m in (
    starcoder2_15b, qwen2_1_5b, mistral_large_123b, stablelm_1_6b,
    phi35_moe_42b, qwen3_moe_30b, llava_next_mistral_7b, zamba2_7b,
    xlstm_1_3b,
)}


def get_config(name: str) -> ArchConfig:
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(
            f"config {name!r} is not ported; ported: {sorted(_CONFIGS)}"
        ) from None


# the autopilot's campaign presets, imported after the registry exists:
# their recipes resolve through get_config
from .autopilot_presets import (  # noqa: E402,F401
    PRESETS,
    AutopilotPreset,
    get_preset,
    preset_names,
)
