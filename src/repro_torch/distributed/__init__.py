"""Training supervision and the GPipe forward (port of
``repro/distributed/fault_tolerance.py`` and ``pipeline.py``; the
gradient compression of ``repro/distributed`` is ROADMAP A12b)."""
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.distributed.pipeline import pipeline_forward

__all__ = ["TrainSupervisor", "pipeline_forward"]
