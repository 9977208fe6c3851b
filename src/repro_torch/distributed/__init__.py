"""Training supervision, the GPipe forward and int8 error-feedback
gradient compression (port of ``repro/distributed/fault_tolerance.py``,
``pipeline.py`` and ``compression.py``)."""
from repro_torch.distributed.compression import (
    EFState,
    compress_decompress,
    compressed_psum,
    ef_init,
)
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.distributed.pipeline import pipeline_forward

__all__ = ["EFState", "ef_init", "compress_decompress", "compressed_psum",
           "TrainSupervisor", "pipeline_forward"]
