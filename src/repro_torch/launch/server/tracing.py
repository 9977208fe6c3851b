"""Request-scoped tracing and the engine flight recorder (port of
``repro/launch/server/tracing.py``; stdlib only at import, so the port
keeps its own copy of the reference's code, and the device clock below
imports torch only for a CUDA device).

A ``TraceRecorder`` is a bounded ring buffer of timing events that is
cheap enough to leave enabled in production: the hot path is one
``time.perf_counter()`` read plus one ``deque.append`` (GIL-atomic, no
lock), and the buffer drops oldest-first when full so a long-lived
server never grows.  Every event is tagged with the recording thread's
id, which is exactly the track structure the Chrome trace-event viewer
wants: one row per pipeline stage (admission / decode / detokenize /
HTTP handler threads).

Two event shapes cover everything the serving stack needs:

* **spans** (``ph: "X"`` complete events) — a duration on one thread:
  an engine decode quantum, a packed prefill, a detokenize batch.
  Recorded via :meth:`TraceRecorder.span_at` (caller captures ``t0``
  with :func:`time.perf_counter` and reports after the work) or the
  :meth:`TraceRecorder.span` context manager.
* **instants** (``ph: "i"``) — a point annotation: a spec-decode
  verify result, a COW prefix adoption, a host-tier restore, an
  offload spill, a preemption.  Args carry page counts / tier labels.

Requests are correlated across threads by their engine request id:
:meth:`req_mark` records lifecycle timestamps (``submit`` /
``admit`` / ``first_token`` / ``done`` — first mark wins, so a
preemption-resume does not reset them), :meth:`req_add` accumulates
per-stage work (``prefill_s``, ``detok_s``), and :meth:`req_timing`
folds them into the ``timing`` breakdown attached to the final SSE
frame and the non-streamed completion response.  The same marks emit a
Chrome *async* track per request (``ph: "b"``/``"e"`` keyed by rid) so
a request's whole lifetime is one bar in Perfetto above the per-thread
spans it touched.

:meth:`export` snapshots the buffer into a Chrome trace-event JSON
object (loads directly in https://ui.perfetto.dev or
``chrome://tracing``).  ``last_s`` restricts the snapshot to the most
recent window — that is the SIGUSR1 "flight recorder" dump: when a
production stall is noticed after the fact, the last N seconds are
still in the ring.

Device clock (the port's own; the reference has no counterpart).
Host spans time what the host does, and a span that ends when its
launches return times the enqueue, not the work.  :class:`DeviceClock`
gives an enabled recorder spans of category ``device`` on the device's
own clock: a *mark* records a CUDA timing event on the current stream
(taken from a small preallocated pool and reused), a span of two marks
waits in a queue, and :meth:`DeviceClock.resolve` turns every queued
span whose end event has completed into a complete event with its
``dev_ms``.  The caller resolves only after a readback it makes anyway,
and ``Event.query`` / ``elapsed_time`` on completed events block on
nothing, so tracing adds no device sync.  Device spans sit on their own
track (``tid`` :data:`DEVICE_TID`, named ``device``): ``dur`` is device
time, and ``ts`` is the host time at which the start event was
recorded, moved past the end of the track's previous span (the stream
runs them in order), a lower bound on when the device began.  On a CPU
device the marks read :func:`time.perf_counter` and ``dev_ms`` is the
host time between them.

Profiler clock.  ``torch.profiler`` stamps its events in Unix-epoch
nanoseconds, while every span here is on the ``perf_counter`` clock
(CLOCK_MONOTONIC).  :meth:`TraceRecorder.profiler_offset_ns` is the
difference of the two clocks now, read from the tightest of a few paired
reads (microseconds); ``round(t * 1e9) + offset`` places a span's
``perf_counter`` time ``t`` on a profiler trace's timeline, so an idle
gap of the device trace can be set against the engine's spans open
across it.  Nothing is added to a profiled run: mirroring the spans as
``record_function`` ranges would add device-side annotation events
that a reader of the trace could take for device work.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["TraceRecorder", "DeviceClock", "DEVICE_TID"]

_PID = 1  # single process; the pid field is just a constant track group
DEVICE_TID = 0  # the device clock's track (no thread has ident 0)


class _NullSpan:
    """Context manager returned by ``span()`` on a disabled recorder."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_rec", "_name", "_cat", "_args", "t0", "dur")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str,
                 args: Optional[dict]):
        self._rec, self._name, self._cat, self._args = rec, name, cat, args
        self.t0 = 0.0
        self.dur = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.dur = t1 - self.t0
        self._rec._append(self.t0, self.dur, "X", self._name, self._cat,
                          self._args)
        return False


class TraceRecorder:
    """Bounded, lock-cheap ring buffer of trace events.

    ``capacity`` bounds memory (drop-oldest); ``enabled=False`` turns
    every recording call into an attribute check + return, so the
    disabled recorder can be threaded through unconditionally.
    """

    def __init__(self, capacity: int = 65536, *, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.t0 = time.perf_counter()
        # Hot path appends without a lock: deque.append is GIL-atomic
        # and maxlen gives drop-oldest for free.  The lock below only
        # serializes export/clear snapshots against each other.
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._recorded = 0
        # Per-request lifecycle marks live outside the ring so a busy
        # buffer cannot lose a request's timing breakdown.  Bounded by
        # _req_cap (drop-oldest) for engine-only callers that never pop.
        self._req_lock = threading.Lock()
        self._req: Dict[int, Dict[str, float]] = {}
        self._req_cap = 8192

    # ---------------------------------------------------------- hot path

    def _append(self, ts: float, dur: float, ph: str, name: str, cat: str,
                args: Optional[dict], tid: Optional[int] = None) -> None:
        self._buf.append((ts, dur, threading.get_ident() if tid is None
                          else tid, ph, name, cat, args))
        self._recorded += 1

    def span(self, name: str, cat: str = "server", **args):
        """Context manager recording a complete event around a block."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def span_at(self, name: str, t0: float, cat: str = "server",
                **args) -> None:
        """Record a complete event from ``t0`` (perf_counter) to now."""
        if not self.enabled:
            return
        self._append(t0, time.perf_counter() - t0, "X", name, cat,
                     args or None)

    def instant(self, name: str, cat: str = "server", **args) -> None:
        if not self.enabled:
            return
        self._append(time.perf_counter(), 0.0, "i", name, cat, args or None)

    def device_span(self, name: str, t0: float, dur: float, **args) -> None:
        """Record a complete event of category ``device`` on the device
        track: ``dur`` seconds of device time placed at ``t0``
        (perf_counter; see :class:`DeviceClock`)."""
        if not self.enabled:
            return
        self._append(t0, dur, "X", name, "device", args or None,
                     tid=DEVICE_TID)

    @staticmethod
    def profiler_offset_ns() -> int:
        """Unix-epoch ns (``torch.profiler``'s clock) less perf_counter ns,
        now, from the tightest of five paired reads."""
        best = None
        for _ in range(5):
            a = time.perf_counter_ns()
            wall = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, wall - (a + b) // 2)
        return best[1]

    # ------------------------------------------------ request lifecycle

    def req_mark(self, rid: int, key: str) -> None:
        """Record a lifecycle timestamp for ``rid`` (first mark wins).

        ``submit`` additionally opens the request's async track.
        """
        if not self.enabled:
            return
        t = time.perf_counter()
        opened = False
        with self._req_lock:
            d = self._req.get(rid)
            if d is None:
                while len(self._req) >= self._req_cap:
                    self._req.pop(next(iter(self._req)))
                d = self._req[rid] = {}
            if key in d:
                return
            d[key] = t
            opened = key == "submit"
        if opened:
            self._append(t, 0.0, "b", "request", "request", {"rid": rid})

    def req_add(self, rid: int, key: str, dt: float) -> None:
        """Accumulate per-stage work (e.g. ``prefill_s``) for ``rid``."""
        if not self.enabled:
            return
        with self._req_lock:
            d = self._req.get(rid)
            if d is not None:
                d[key] = d.get(key, 0.0) + dt

    def req_done(self, rid: int) -> None:
        """Mark request completion time (first mark wins)."""
        self.req_mark(rid, "done")

    def req_timing(self, rid: int, *, pop: bool = True) -> Optional[dict]:
        """Fold marks into the per-request ``timing`` breakdown.

        Popping also closes the request's async track (the ``"e"``
        event lands *after* the final tokens streamed, so every
        ``tok.stream`` instant falls inside its request span).
        Returns ``None`` when disabled or the rid is unknown.
        """
        if not self.enabled:
            return None
        t = time.perf_counter()
        with self._req_lock:
            d = self._req.pop(rid, None) if pop else self._req.get(rid)
        if d is None:
            return None
        submit = d.get("submit")
        admit = d.get("admit")
        first = d.get("first_token")
        done = d.get("done", t)
        if submit is not None and admit is not None:
            queue_wait = max(admit - submit, 0.0)
        elif submit is not None:
            queue_wait = max(done - submit, 0.0)
        else:
            queue_wait = 0.0
        timing = {
            "queue_wait_s": round(queue_wait, 6),
            "prefill_s": round(d.get("prefill_s", 0.0), 6),
            "decode_s": round(max(done - first, 0.0) if first is not None
                              else 0.0, 6),
            "detok_s": round(d.get("detok_s", 0.0), 6),
            "total_s": round(max(done - submit, 0.0) if submit is not None
                             else 0.0, 6),
        }
        if pop and submit is not None:
            self._append(t, 0.0, "e", "request", "request", {"rid": rid})
        return timing

    # ----------------------------------------------------------- export

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def dropped(self) -> int:
        return max(self._recorded - len(self._buf), 0)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._recorded = 0

    def _thread_names(self) -> Dict[int, str]:
        names = {t.ident: t.name for t in threading.enumerate()
                 if t.ident is not None}
        names[DEVICE_TID] = "device"
        return names

    def export(self, *, last_s: Optional[float] = None) -> dict:
        """Snapshot the ring as a Chrome trace-event JSON object.

        ``last_s`` keeps only events whose start lies within the
        trailing window (the flight-recorder dump).  Timestamps are
        microseconds relative to recorder construction, so successive
        exports share one time base.
        """
        with self._lock:
            events = list(self._buf)
            recorded, dropped = self._recorded, self.dropped
        now = time.perf_counter()
        if last_s is not None:
            cut = now - last_s
            events = [e for e in events if e[0] >= cut]
        names = self._thread_names()
        out: List[dict] = []
        tids = set()
        for ts, dur, tid, ph, name, cat, args in events:
            tids.add(tid)
            ev: Dict[str, Any] = {
                "name": name, "cat": cat, "ph": ph,
                "ts": round((ts - self.t0) * 1e6, 3),
                "pid": _PID, "tid": tid,
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            elif ph == "i":
                ev["s"] = "t"
            elif ph in ("b", "e"):
                ev["id"] = (args or {}).get("rid", 0)
            if args:
                ev["args"] = args
            out.append(ev)
        for tid in sorted(tids):
            out.append({"name": "thread_name", "ph": "M", "pid": _PID,
                        "tid": tid,
                        "args": {"name": names.get(tid, f"thread-{tid}")}})
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "capacity": self.capacity,
                "recorded": recorded,
                "dropped": dropped,
                "window_s": last_s,
                "clock": "perf_counter",
            },
        }

    def export_json(self, *, last_s: Optional[float] = None) -> str:
        return json.dumps(self.export(last_s=last_s))

    def write(self, path: str, *, last_s: Optional[float] = None) -> int:
        """Write an export to ``path``; returns the event count."""
        obj = self.export(last_s=last_s)
        with open(path, "w") as f:
            json.dump(obj, f)
        return len(obj["traceEvents"])


class DeviceClock:
    """Spans on the device's clock for one engine (see the module
    docstring): ``mark()`` a point on the stream, ``push`` a span of two
    marks, ``resolve(rec)`` after a readback.

    A span pushed with ``gap=True`` also gets ``gap_ms``, the device time
    from the end of the previous such span to its own start (absent on
    the first).  ``charge`` names request ids whose ``prefill_s`` the
    span's device time is added to (``TraceRecorder.req_add``).  The pool
    holds 16 events to begin with; an empty pool makes another, which
    then stays in it."""

    def __init__(self, device):
        self.device = device
        self._events = None
        self._free: list = []
        if device.type == "cuda":
            import torch

            self._events = torch.cuda
            self._free = [torch.cuda.Event(enable_timing=True)
                          for _ in range(16)]
        self._queue: deque = deque()
        self._last_gap = None  # the end mark of the last gap=True span
        self._cursor = 0.0  # where the device track's last span ends

    def mark(self) -> tuple:
        """(host perf_counter time, the event recorded, or None on a CPU
        device)."""
        t = time.perf_counter()
        if self._events is None:
            return t, None
        ev = self._free.pop() if self._free else \
            self._events.Event(enable_timing=True)
        ev.record(self._events.current_stream(self.device))
        return t, ev

    def push(self, name: str, start: tuple, end: tuple, *,
             gap: bool = False, charge=(), **args) -> None:
        self._queue.append((name, start, end, gap, charge, args))

    @staticmethod
    def _ms(a: tuple, b: tuple) -> float:
        if a[1] is None:
            return (b[0] - a[0]) * 1e3
        return a[1].elapsed_time(b[1])

    def _release(self, m: tuple) -> None:
        if m[1] is not None:
            self._free.append(m[1])

    @property
    def pending(self) -> int:
        return len(self._queue)

    def resolve(self, rec: TraceRecorder) -> None:
        """Record, in order, every queued span whose end event has
        completed (``Event.query``, which does not block); the rest wait
        for the next readback."""
        while self._queue:
            name, start, end, gap, charge, args = self._queue[0]
            if end[1] is not None and not end[1].query():
                return
            self._queue.popleft()
            dev_ms = self._ms(start, end)
            args = dict(args, dev_ms=dev_ms)
            if gap:
                if self._last_gap is not None:
                    args["gap_ms"] = self._ms(self._last_gap, start)
                    self._release(self._last_gap)
                self._last_gap = end
            else:
                self._release(end)
            self._release(start)
            t0 = max(start[0], self._cursor)
            self._cursor = t0 + dev_ms / 1e3
            rec.device_span(name, t0, dev_ms / 1e3, **args)
            for rid in charge:
                rec.req_add(rid, "prefill_s", dev_ms / 1e3)
