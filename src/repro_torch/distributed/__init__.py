"""Training supervision (port of ``repro/distributed/fault_tolerance.py``;
the rest of ``repro/distributed`` is ROADMAP A12)."""
from repro_torch.distributed.fault_tolerance import TrainSupervisor

__all__ = ["TrainSupervisor"]
