"""Async serving front-end (port of ``repro/launch/server``, with the
reference's ``__all__``).

A threaded prefill/decode/detokenize pipeline over the port's
``BatchEngine`` (pipeline.py), deterministic bucketed admission that
packs same-length prompts into one batched prefill (admission.py), a
stdlib-only HTTP/SSE front-end with /healthz, /metrics and /debug/trace
(http.py), seeded workload traces shared by the CLI and
``chip_smoke.py`` (trace.py), and the metrics / machine-readable
cache-report helpers both serving paths print through (stats.py).
Request-scoped tracing and the engine flight recorder live in
tracing.py -- note trace.py (workload traces) and tracing.py (timeline
recorder) are different modules.
"""
from repro_torch.launch.server.admission import BucketedAdmission
from repro_torch.launch.server.http import CompletionServer
from repro_torch.launch.server.pipeline import (
    Backpressure,
    ServingPipeline,
    StreamEvent,
    SyncServer,
)
from repro_torch.launch.server.stats import (
    Histogram,
    ServerMetrics,
    cache_report_data,
)
from repro_torch.launch.server.trace import (
    TraceItem,
    bucket_lengths,
    make_requests,
    make_trace,
)
from repro_torch.launch.server.tracing import TraceRecorder

__all__ = [
    "Backpressure",
    "BucketedAdmission",
    "CompletionServer",
    "Histogram",
    "ServerMetrics",
    "ServingPipeline",
    "StreamEvent",
    "SyncServer",
    "TraceItem",
    "TraceRecorder",
    "bucket_lengths",
    "cache_report_data",
    "make_requests",
    "make_trace",
]
