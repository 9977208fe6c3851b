"""The device trace of a fixed stretch of the window, reduced to numbers.

``Stretch`` runs ``torch.profiler`` (CPU and CUDA activities) around the
stretch and keeps, in memory only, every device activity (kernels,
copies, fills) and the benchmark's own host annotations
(``record_function`` ranges).  ``reduce`` gives the stretch's wall
seconds, the seconds in which an operation ran on the device (the union
of the activities), device seconds by operation name, and the idle gaps,
each labelled by the innermost host annotation open where the gap
begins.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch

__all__ = ["STRETCH", "Stretch", "Trace", "reduce"]

STRETCH = "bench.stretch"


@dataclasses.dataclass
class Trace:
    start_ns: int
    end_ns: int
    ops: list  # (start_ns, end_ns, name) device activities
    annotations: list  # (start_ns, end_ns, name) host ranges

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


class Stretch:
    """``with Stretch(annotations) as st: ...``; then ``st.trace``."""

    def __init__(self, annotations: set):
        self.names = set(annotations) | {STRETCH}
        self.trace: Optional[Trace] = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.rf = torch.profiler.record_function(STRETCH)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        ops, ann = [], []
        for e in self.prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if e.name() in self.names:
                # a host range; its device-side mirror is no operation
                if "CUDA" in str(e.device_type()):
                    continue
                ann.append((start, end, e.name()))
            elif "CUDA" in str(e.device_type()):
                ops.append((start, end, e.name()))
        outer = [a for a in ann if a[2] == STRETCH]
        s0, s1 = (outer[0][0], outer[0][1]) if outer else (
            min((o[0] for o in ops), default=0),
            max((o[1] for o in ops), default=0))
        ops = [o for o in ops if o[1] > s0 and o[0] < s1]
        self.trace = Trace(s0, s1, sorted(ops), sorted(ann))
        del self.prof
        return False


def _union(ops, s0, s1) -> list:
    """Merged busy intervals of ``ops`` clipped to [s0, s1]."""
    out = []
    for a, b, _ in ops:
        a, b = max(a, s0), min(b, s1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(t: int, annotations) -> str:
    best = None
    for a, b, name in annotations:
        if a <= t < b and name != STRETCH and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else "client"


def reduce(tr: Trace, top: int = 10) -> dict:
    busy = _union(tr.ops, tr.start_ns, tr.end_ns)
    busy_s = sum(b - a for a, b in busy) / 1e9
    by_name = collections.Counter()
    for a, b, name in tr.ops:
        by_name[name] += (b - a) / 1e9
    gaps, t = [], tr.start_ns
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if tr.end_ns > t:
        gaps.append((t, tr.end_ns))
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "window_s": tr.window_s,
        "busy_s": busy_s,
        "device_ops": [[n[:160], s] for n, s in by_name.most_common(top)],
        "idle_gaps": [[_label(a, tr.annotations), (b - a) / 1e9]
                      for a, b in longest],
        "op_seconds": dict(by_name),
    }
