"""Request-scoped tracing and the engine flight recorder (port of
``repro/launch/server/tracing.py``; stdlib only, so the port keeps its
own copy of the reference's code).

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
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["TraceRecorder"]

_PID = 1  # single process; the pid field is just a constant track group


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
                args: Optional[dict]) -> None:
        self._buf.append((ts, dur, threading.get_ident(), ph, name, cat,
                          args))
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
        return {t.ident: t.name for t in threading.enumerate()
                if t.ident is not None}

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
