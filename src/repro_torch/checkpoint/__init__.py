"""Atomic checkpoints of tensor trees (the port's copy of ``repro.checkpoint``)."""
from .manager import CheckpointManager, latest_step, manifest_extra, restore, save

__all__ = ["CheckpointManager", "latest_step", "manifest_extra", "restore", "save"]
