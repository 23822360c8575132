"""Checkpoints: trainer trees (atomic save, restore, keep-last-k, async
writes) and serving-state blobs (``save_state``/``load_state``)."""
from .checkpoint import (
    CheckpointManager,
    latest_step,
    load_state,
    restore,
    save,
    save_state,
)

__all__ = ["CheckpointManager", "latest_step", "load_state", "restore", "save", "save_state"]
