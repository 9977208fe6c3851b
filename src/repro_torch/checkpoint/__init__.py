"""Atomic step checkpoints with keep-k GC and exact resume (port of
``repro/checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
