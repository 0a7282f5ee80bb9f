"""Fault-tolerant checkpointing: atomic, async, manifested (the reference's
format)."""
from .store import (
    CheckpointManager,
    checkpoint_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)

__all__ = [
    "CheckpointManager", "checkpoint_steps", "latest_step",
    "restore_checkpoint", "save_checkpoint", "verify_checkpoint",
]
