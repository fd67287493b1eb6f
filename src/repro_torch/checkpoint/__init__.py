"""Fault-tolerance substrate: atomic checkpointing."""
from .manager import CheckpointManager  # noqa: F401
