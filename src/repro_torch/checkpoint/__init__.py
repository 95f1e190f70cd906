"""Checkpointing: scrub-on-save, async save, restore with reference repair."""
from .manager import (  # noqa: F401
    CheckpointManager, latest_step, load_checkpoint, save_checkpoint,
)
