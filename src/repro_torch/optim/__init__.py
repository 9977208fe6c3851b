"""Functional AdamW and schedules (port of ``repro/optim``)."""
from repro_torch.optim.adam import (
    AdamState,
    adam_init,
    adam_update,
    clip_by_global_norm,
    cosine_schedule,
)

__all__ = ["AdamState", "adam_init", "adam_update", "clip_by_global_norm",
           "cosine_schedule"]
