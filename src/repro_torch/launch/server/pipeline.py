"""Threaded prefill/decode/detokenize pipeline (port of
``repro/launch/server/pipeline.py`` over the port's ``BatchEngine``).

``ServingPipeline`` runs three stages over one ``BatchEngine``:

* **admission** -- drains the bounded intake queue into the
  ``BucketedAdmission`` bucketizer and fires packed prefill dispatches
  whenever head groups fit the free slots;
* **decode** -- calls ``engine.step()`` while the engine has work (one
  decode chunk per quantum);
* **detokenize** -- consumes the engine's step-listener stream through
  a bounded queue: byte-decodes tokens, builds per-request
  ``StreamEvent``s, updates TTFT/ITL histograms and fans out to
  per-request stream queues (what the HTTP layer writes as SSE).

One device, one engine lock: admission and decode serialize on
``engine.lock``, so the pipeline never reorders DEVICE work -- a launch
sequence is always some legal single-threaded schedule.  The lock also
covers the decode graph's capture (the first ``step()`` on a card): a
CUDA call from another thread during a capture would fail it, and every
device touch of the engine happens under the lock, while the listener,
the detokenize stage and the HTTP threads see host data only.  What the
pipeline overlaps is HOST work: a decode chunk spends its device time in
``CUDAGraph.replay`` and in the chunk's blocking readback (a ``.cpu()``),
and PyTorch releases the GIL in both, so detokenization/SSE formatting
and intake bookkeeping run *beside* the device instead of between
chunks.  Per-request token BITS are unchanged (greedy decode bits at a
fixed batch width are independent of which other rows are live, and
packed-prefill widths are fixed by arrival order).

Backpressure contract: the intake queue is bounded -- a full queue
rejects the submit with :class:`Backpressure` (HTTP 429) BEFORE any
engine state or ``torch.Generator`` draw is touched, so a rejected
request leaves the token streams of every accepted one untouched.  The
detokenize queue is bounded too: if formatting ever lags, the step
listener's blocking put stalls the decode thread rather than buffering
tokens without limit.

``SyncServer`` is the single-threaded reference: the SAME bucketizer
and the SAME fan-out/metrics code, called inline between scheduler
quanta.  Its token streams equal the pipeline's bit for bit under one
arrival order (the tests and ``chip_smoke.py`` hold them to it).
"""
from __future__ import annotations

import dataclasses
import json
import math
import queue
import threading
import time
from typing import Optional

from repro_torch.launch.batch_engine import BatchEngine, Completion, Request
from repro_torch.launch.server.admission import BucketedAdmission
from repro_torch.launch.server.stats import ServerMetrics
from repro_torch.launch.server.tracing import TraceRecorder

__all__ = ["Backpressure", "StreamEvent", "TokenFanout",
           "ServingPipeline", "SyncServer", "drain_stream"]


class Backpressure(RuntimeError):
    """Intake rejected: admission queue full or server draining.  The
    HTTP layer maps this to 429 with a ``Retry-After`` of
    ``retry_after`` seconds (integer, >= 1 -- derived from queue depth
    and the admission hold-off at rejection time); nothing engine-side
    was consumed."""

    def __init__(self, msg: str, retry_after: int = 1):
        super().__init__(msg)
        self.retry_after = max(int(retry_after), 1)


@dataclasses.dataclass
class StreamEvent:
    """One SSE-shaped increment of a request's stream.  The final
    event carries ``finish_reason`` (and no tokens).  ``sse`` is the
    ready-to-write ``data:`` payload: serialization happens in the
    detokenize stage -- per-token host work the pipeline overlaps with
    device time -- so the HTTP handler thread only copies bytes."""

    rid: int
    tokens: list[int]
    text: str
    finish_reason: Optional[str] = None
    sse: str = ""
    # final events only, tracing enabled: the per-request breakdown
    # (queue_wait_s / prefill_s / decode_s / detok_s / total_s) from
    # the trace recorder's lifecycle marks (DESIGN.md §15)
    timing: Optional[dict] = None


class TokenFanout:
    """Routes engine ``(events, completions)`` batches to per-request
    stream queues and the metrics object.  Shared verbatim by the
    threaded pipeline (detokenize thread) and the sync reference loop
    (inline), so both paths pay the SAME per-token host work -- the
    load comparison then measures overlap, not work difference."""

    def __init__(self, metrics: ServerMetrics, trace=None):
        self.metrics = metrics
        self.trace = trace if trace is not None \
            else TraceRecorder(capacity=1, enabled=False)
        self._lock = threading.Lock()
        self._streams: dict[int, queue.Queue] = {}
        self._t_arrival: dict[int, float] = {}
        self._t_last: dict[int, float] = {}

    def register(self, rid: int, t_arrival: float) -> queue.Queue:
        with self._lock:
            if rid in self._streams:
                raise ValueError(f"duplicate rid {rid}")
            q = queue.Queue()  # unbounded: never deadlocks a slow reader
            self._streams[rid] = q
            self._t_arrival[rid] = t_arrival
            return q

    def unregister(self, rid: int) -> None:
        with self._lock:
            self._streams.pop(rid, None)
            self._t_arrival.pop(rid, None)
            self._t_last.pop(rid, None)

    @property
    def open_streams(self) -> int:
        return len(self._streams)

    def process(self, events, completions, t: float) -> None:
        """The detokenize stage: decode bytes, time, fan out.  Token
        events first, then completions -- a request finishing inside a
        batch streams its last tokens before its finish event."""
        m = self.metrics
        tr = self.trace
        for rid, toks in events:
            if not toks:
                continue
            t0w = time.perf_counter()
            with self._lock:
                q = self._streams.get(rid)
                t_arr = self._t_arrival.get(rid)
                t_prev = self._t_last.get(rid)
                self._t_last[rid] = t
            toks = list(toks)
            text = "".join(chr(c) if 32 <= c < 127 else "?" for c in toks)
            sse = json.dumps({"rid": rid, "tokens": toks, "text": text,
                              "finish_reason": None})
            with m.lock:
                m.tokens_streamed += len(toks)
                if t_prev is None:
                    if t_arr is not None:
                        m.ttft.record(t - t_arr)
                else:
                    dt = (t - t_prev) / len(toks)
                    for _ in toks:
                        m.itl.record(dt)
            if q is not None:
                q.put(StreamEvent(rid=rid, tokens=toks, text=text,
                                  sse=sse))
            tr.span_at("detok", t0w, cat="detok", rid=rid, n=len(toks))
            tr.req_add(rid, "detok_s", time.perf_counter() - t0w)
            tr.instant("tok.stream", cat="token", rid=rid, n=len(toks))
        for comp in completions:
            with self._lock:
                q = self._streams.pop(comp.rid, None)
                t_arr = self._t_arrival.pop(comp.rid, None)
                self._t_last.pop(comp.rid, None)
            with m.lock:
                if comp.finish_reason == "cancelled":
                    m.cancelled += 1
                else:
                    m.completed += 1
                if t_arr is not None:
                    m.e2e.record(t - t_arr)
            # popping the timing closes the request's trace track: the
            # "e" event lands HERE, after its last tokens streamed, so
            # every tok.stream instant falls inside the request span
            timing = tr.req_timing(comp.rid)
            if q is not None:
                payload = {"rid": comp.rid, "tokens": [], "text": "",
                           "finish_reason": comp.finish_reason}
                if timing is not None:
                    payload["timing"] = timing
                q.put(StreamEvent(rid=comp.rid, tokens=[], text="",
                                  finish_reason=comp.finish_reason,
                                  sse=json.dumps(payload), timing=timing))

    def close_all(self, reason: str) -> None:
        """Finish every still-open stream (shutdown: requests that
        never reached the engine get a terminal event too)."""
        with self._lock:
            left = list(self._streams.items())
            self._streams.clear()
            self._t_arrival.clear()
            self._t_last.clear()
        for rid, q in left:
            with self.metrics.lock:
                self.metrics.cancelled += 1
            self.trace.req_timing(rid)  # close the trace track, if any
            sse = json.dumps({"rid": rid, "tokens": [], "text": "",
                              "finish_reason": reason})
            q.put(StreamEvent(rid=rid, tokens=[], text="",
                              finish_reason=reason, sse=sse))


def drain_stream(q: "queue.Queue[StreamEvent]",
                 timeout: float = 120.0) -> tuple[list[int], str]:
    """Read one stream queue to its finish event.  Returns
    ``(tokens, finish_reason)`` -- the test-side consumer."""
    toks: list[int] = []
    deadline = time.monotonic() + timeout
    while True:
        ev = q.get(timeout=max(deadline - time.monotonic(), 0.001))
        toks.extend(ev.tokens)
        if ev.finish_reason is not None:
            return toks, ev.finish_reason


class ServingPipeline:
    """The threaded serving front-end over one ``BatchEngine``.

    ``start()`` spawns the three stage threads; ``submit()`` is
    thread-safe (HTTP handler threads call it) and returns the
    request's stream queue; ``shutdown()`` drains or cancels.  The
    engine must be dedicated to the pipeline while it runs (the
    pipeline registers a step listener and assumes every admission
    goes through it)."""

    def __init__(self, engine: BatchEngine, *,
                 max_group: Optional[int] = None,
                 admit_queue: int = 64, detok_queue: int = 256,
                 admit_hold_s: float = 0.002,
                 trace: Optional[TraceRecorder] = None):
        self.engine = engine
        # one recorder per serving stack (DESIGN.md §15): adopt the
        # engine's if the caller already enabled one there, otherwise
        # create our own (tracing is on by default) and point the engine
        # at it.
        if trace is None:
            trace = engine.trace if engine.trace.enabled \
                else TraceRecorder()
        self.trace = trace
        engine.trace = trace
        # micro-batching hold-off: a PARTIAL head group whose newest
        # arrival is younger than this waits one beat before admission
        # fires, so a burst of same-length arrivals lands as ONE packed
        # prefill instead of fragmenting into whatever the
        # thread race happened to drain (the sync loop coalesces for
        # free -- arrivals pile up during its quanta).  Full groups and
        # drains never wait.
        self.admit_hold_s = admit_hold_s
        self.metrics = ServerMetrics()
        self.fanout = TokenFanout(self.metrics, trace=self.trace)
        self.bucketizer = BucketedAdmission(engine, max_group=max_group)
        self.admit_queue_cap = admit_queue
        self._admit_q: "queue.Queue[Request]" = queue.Queue(
            maxsize=admit_queue
        )
        self._detok_q: "queue.Queue[Optional[tuple]]" = queue.Queue(
            maxsize=detok_queue
        )
        self._stop = threading.Event()
        self._closing = False
        self._admit_wake = threading.Event()
        self._work_wake = threading.Event()
        self._threads: list[threading.Thread] = []
        engine.step_listeners.append(self._on_step)

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "ServingPipeline":
        for name, fn in (("admission", self._admission_loop),
                         ("decode", self._decode_loop),
                         ("detokenize", self._detok_loop)):
            t = threading.Thread(target=fn, name=f"serve-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def drain(self, timeout: float = 120.0) -> bool:
        """Stop intake and wait until every accepted request has fully
        streamed (queues empty, engine idle, fan-out flushed)."""
        self._closing = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if (self._admit_q.empty() and self.bucketizer.depth == 0
                    and not self.engine.has_work
                    and self._detok_q.empty()
                    and self.fanout.open_streams == 0):
                return True
            self._admit_wake.set()
            self._work_wake.set()
            time.sleep(0.005)
        return False

    def shutdown(self, *, cancel: bool = False,
                 timeout: float = 120.0) -> bool:
        """Stop the pipeline.  Graceful by default (drain, then stop
        threads); ``cancel=True`` is the SIGINT path: live requests are
        cancelled through ``engine.cancel_all`` (their partial streams
        get a ``finish_reason="cancelled"`` terminal event) and, paged,
        every pool page returns to the free list.  Returns True when
        the drain completed inside ``timeout``."""
        self._closing = True
        drained = True if cancel else self.drain(timeout)
        self._stop.set()
        self._admit_wake.set()
        self._work_wake.set()
        for t in self._threads:
            if t.name != "serve-detokenize":
                t.join(timeout=10.0)
        if cancel:
            # admission/decode threads are parked; the detokenize
            # thread still runs, so the cancellation batch flows
            # through the normal listener -> fan-out path
            self.bucketizer.cancel_pending()
            while True:
                try:
                    self._admit_q.get_nowait()
                except queue.Empty:
                    break
            self.engine.cancel_all()
        self._detok_q.put(None)
        for t in self._threads:
            if t.name == "serve-detokenize":
                t.join(timeout=10.0)
        if cancel:
            # streams whose requests never reached the engine
            self.fanout.close_all("cancelled")
        try:
            self.engine.step_listeners.remove(self._on_step)
        except ValueError:
            pass
        return drained

    # ----------------------------------------------------------------- intake
    def submit(self, req: Request) -> queue.Queue:
        """Thread-safe intake.  Returns the request's stream queue.
        Raises :class:`Backpressure` when the admission queue is full
        or the server is draining -- BEFORE the engine or its generator
        is touched (a 429'd client changes nothing for anyone else)."""
        if self._closing:
            raise Backpressure("server is draining",
                               retry_after=self._retry_after())
        # validate NOW (raises ValueError -> HTTP 400): a bad request
        # must bounce at intake, not blow up the admission thread later
        plen = self.engine._validate(req)
        t = time.perf_counter()
        stream = self.fanout.register(req.rid, t)
        try:
            self._admit_q.put_nowait(req)
        except queue.Full:
            self.fanout.unregister(req.rid)
            with self.metrics.lock:
                self.metrics.rejected += 1
            self.trace.instant("req.reject", cat="request", rid=req.rid,
                               reason="queue_full")
            raise Backpressure(
                f"admission queue full ({self.admit_queue_cap})",
                retry_after=self._retry_after(),
            ) from None
        with self.metrics.lock:
            self.metrics.received += 1
        self.trace.req_mark(req.rid, "submit")
        self.trace.instant("req.submit", cat="request", rid=req.rid,
                           prompt_len=plen,
                           max_new=req.max_new_tokens)
        self._admit_wake.set()
        return stream

    def _retry_after(self) -> int:
        """Retry-After seconds for a 429: how long the CURRENT backlog
        plausibly takes to clear -- one admission hold-off beat per
        queued request (the floor the admission loop drains at), rounded
        up to whole seconds (the header's unit), never below 1."""
        backlog = self._admit_q.qsize() + self.bucketizer.depth
        hold = max(self.admit_hold_s, 0.001)
        return max(1, math.ceil(backlog * hold))

    def replay(self, items, *, drain_timeout: float = 600.0) -> float:
        """Open-loop trace replay: submit each item
        at its arrival offset -- retrying through backpressure so no
        trace item is dropped -- then drain.  Returns the makespan in
        seconds (first submit to fully drained)."""
        t0 = time.perf_counter()
        for item in items:
            dt = item.arrival_s - (time.perf_counter() - t0)
            if dt > 0:
                time.sleep(dt)
            while True:
                try:
                    self.submit(item.req)
                    break
                except Backpressure:
                    time.sleep(0.002)
        self.drain(timeout=drain_timeout)
        return time.perf_counter() - t0

    # ------------------------------------------------------------ observability
    def queue_depths(self) -> dict:
        return {
            "admit_queue_depth": self._admit_q.qsize(),
            "bucket_depth": self.bucketizer.depth,
            "detok_queue_depth": self._detok_q.qsize(),
            "open_streams": self.fanout.open_streams,
        }

    def metrics_text(self) -> str:
        """Prometheus-style ``/metrics`` body: pipeline counters and
        histograms plus live gauges (queue depths, slot occupancy,
        pool utilization)."""
        eng = self.engine
        gauges = dict(self.queue_depths())
        gauges["slots_active"] = eng.n_active
        gauges["slots_capacity"] = eng.capacity
        gauges["packed_groups_total"] = self.bucketizer.n_groups
        gauges["packed_requests_total"] = self.bucketizer.n_packed
        pool = eng.pool_stats()
        if pool:
            gauges["pool_pages_used"] = pool["pages_used"]
            gauges["pool_pages_total"] = pool["n_pages"]
            gauges["pool_utilization"] = float(pool["utilization"])
            gauges["pool_preemptions_total"] = pool["preemptions"]
            gauges["host_bytes_total"] = pool["host_bytes"]["total"]
            off = pool["offload"]
            gauges["prefix_hits_device_total"] = off["hits_device"]
            gauges["prefix_hits_host_total"] = off["hits_host"]
            gauges["prefix_misses_total"] = off["misses"]
            if off["enabled"]:
                gauges["offload_spilled_pages_total"] = off["spilled_pages"]
                gauges["offload_restored_pages_total"] = off["restored_pages"]
                gauges["offload_restored_tokens_total"] = off["restored_tokens"]
                gauges["offload_ram_bytes"] = off["store"]["ram_bytes"]
                gauges["offload_disk_bytes"] = off["store"]["disk_bytes"]
        if getattr(eng, "spec_k", None):
            gauges["spec_k"] = eng.spec_k
            gauges["spec_tokens_drafted_total"] = int(eng.n_drafted)
            gauges["spec_tokens_accepted_total"] = int(eng.n_accepted)
            gauges["spec_tokens_rejected_total"] = int(eng.n_rejected)
            gauges["spec_acceptance_rate"] = float(
                eng.n_accepted / max(eng.n_drafted, 1)
            )
        gauges["trace_events"] = len(self.trace)
        gauges["trace_dropped_total"] = self.trace.dropped
        labeled = {}
        outcomes = getattr(eng, "tier_outcomes", None)
        if outcomes:
            labeled["prefix_tier_requests_total"] = (
                "counter",
                "Retired requests by admission prefix tier and outcome",
                [({"tier": tier, "outcome": oc}, n)
                 for tier, byo in sorted(outcomes.items())
                 for oc, n in sorted(byo.items())],
            )
        return self.metrics.render_prometheus(gauges, labeled)

    # ------------------------------------------------------------ stage loops
    def _on_step(self, events: list, completions: list[Completion]) -> None:
        # engine lock is held here; the blocking put is the detokenize
        # backpressure (a lagging formatter stalls decode rather than
        # buffering without bound).  The detokenize thread never takes
        # the engine lock, so this cannot deadlock.
        self._detok_q.put((events, completions, time.perf_counter()))

    def _admission_loop(self) -> None:
        t_newest = None
        while not self._stop.is_set():
            self._admit_wake.wait(timeout=0.05)
            self._admit_wake.clear()
            while True:
                try:
                    self.bucketizer.offer(self._admit_q.get_nowait())
                except queue.Empty:
                    break
                t_newest = time.perf_counter()
            if self.bucketizer.depth:
                hold = (
                    self.admit_hold_s > 0.0
                    and not self._closing
                    # only while the device is busy: the hold then
                    # hides behind the running quantum; on an idle
                    # engine admitting NOW is strictly better
                    and self.engine.has_work
                    and t_newest is not None
                    and time.perf_counter() - t_newest < self.admit_hold_s
                    and self.bucketizer.head_group_len()
                        < min(self.bucketizer.max_group,
                              self.engine.n_free_slots)
                )
                if hold:
                    # partial group, arrivals still landing: wait one
                    # beat so the burst packs into one dispatch
                    self.trace.instant(
                        "admit.hold", cat="sched",
                        head_group=self.bucketizer.head_group_len(),
                        depth=self.bucketizer.depth,
                    )
                    time.sleep(min(self.admit_hold_s, 0.001))
                    self._admit_wake.set()
                else:
                    t0a = time.perf_counter()
                    moved = self.bucketizer.admit()
                    if moved:
                        self.trace.span_at("admit.sweep", t0a,
                                           cat="sched", admitted=moved)
            if self.engine.has_work:
                self._work_wake.set()

    def _decode_loop(self) -> None:
        while not self._stop.is_set():
            if self.engine.has_work:
                self.engine.step()
                self._admit_wake.set()  # retirements may have freed slots
            else:
                self._work_wake.wait(timeout=0.02)
                self._work_wake.clear()

    def _detok_loop(self) -> None:
        while True:
            item = self._detok_q.get()
            if item is None:
                return
            self.fanout.process(*item)


class SyncServer:
    """Single-threaded reference loop: the SAME ``BucketedAdmission``
    grouping and the SAME ``TokenFanout`` per-token host work as the
    pipeline, all called inline between scheduler quanta -- so
    detokenization sits between decode chunks instead of beside them.
    The pipeline's token streams must match this loop's bit-for-bit under
    one arrival order (greedy sampling), and ``chip_smoke.py`` times the
    two against each other in req/s."""

    def __init__(self, engine: BatchEngine, *,
                 max_group: Optional[int] = None,
                 trace: Optional[TraceRecorder] = None):
        self.engine = engine
        if trace is None:
            trace = engine.trace if engine.trace.enabled \
                else TraceRecorder()
        self.trace = trace
        engine.trace = trace
        self.metrics = ServerMetrics()
        self.fanout = TokenFanout(self.metrics, trace=self.trace)
        self.bucketizer = BucketedAdmission(engine, max_group=max_group)
        self._listener = self._on_step
        engine.step_listeners.append(self._listener)

    def _on_step(self, events, completions) -> None:
        self.fanout.process(events, completions, time.perf_counter())

    def submit(self, req: Request) -> queue.Queue:
        plen = self.engine._validate(req)
        stream = self.fanout.register(req.rid, time.perf_counter())
        with self.metrics.lock:
            self.metrics.received += 1
        self.trace.req_mark(req.rid, "submit")
        self.trace.instant("req.submit", cat="request", rid=req.rid,
                           prompt_len=plen, max_new=req.max_new_tokens)
        self.bucketizer.offer(req)
        return stream

    def run_until_drained(self) -> None:
        """Closed-loop service: admit + decode until nothing is left."""
        while self.bucketizer.depth or self.engine.has_work:
            self.bucketizer.admit()
            if self.engine.has_work:
                self.engine.step()

    def replay(self, items) -> float:
        """Open-loop trace replay, single-threaded: arrivals are
        checked between quanta (a submit can wait for the running
        quantum -- exactly the serialization the pipeline removes).
        Returns the makespan in seconds."""
        t0 = time.perf_counter()
        i, n = 0, len(items)
        while i < n or self.bucketizer.depth or self.engine.has_work:
            now = time.perf_counter() - t0
            while i < n and items[i].arrival_s <= now:
                self.submit(items[i].req)
                i += 1
            self.bucketizer.admit()
            if self.engine.has_work:
                self.engine.step()
            elif i < n:
                time.sleep(min(max(items[i].arrival_s - now, 0.0), 0.01))
        return time.perf_counter() - t0

    def close(self) -> None:
        try:
            self.engine.step_listeners.remove(self._listener)
        except ValueError:
            pass
