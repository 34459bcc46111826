"""Fault-tolerant checkpointing: atomic save/restore and an async writer —
the port of ``repro/checkpoint``."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
