"""Checkpoint/restart substrate: npz checkpoints in the reference's layout,
async saves, and restores onto the like-tree's devices."""

from .store import (CheckpointStore, save_checkpoint, restore_checkpoint,
                    estimate_restore_seconds, latest_step)

__all__ = ["CheckpointStore", "save_checkpoint", "restore_checkpoint",
           "estimate_restore_seconds", "latest_step"]
