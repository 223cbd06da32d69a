"""Fault-tolerant checkpointing of the port."""
from repro_torch.checkpoint.checkpointing import CheckpointManager

__all__ = ["CheckpointManager"]
