"""Atomic, checksummed, async checkpointing (the port of ``repro.checkpoint``)."""
from .manager import CheckpointManager, host_copy, restore_like

__all__ = ["CheckpointManager", "host_copy", "restore_like"]
