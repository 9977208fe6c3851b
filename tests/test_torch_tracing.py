"""Request-scoped tracing in the port (``repro_torch.launch.server.tracing``
and the engine's span and instant sites) against
``repro.launch.server.tracing`` and the reference engine's trace, and the
reference's tracing invariants proven within the port.  CPU, smol-d64,
``S_MAX`` 48, capacity 3, plain kernel versions.

Tolerances: none.  The recorder's export equals the reference's on the
same calls, with timestamps, durations and thread ids masked; the engine
records the reference engine's events (names, categories, phases and
arguments) in the reference's order on the same workload; streams with
tracing on equal streams with tracing off bit for bit; a traced pipeline
run passes ``benchmarks/check_trace.py``; ``/metrics`` is strict
Prometheus text."""
import pytest

torch = pytest.importorskip("torch")

import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.batch_engine import BatchEngine as JBatchEngine  # noqa: E402
from repro.launch.batch_engine import Request as JRequest  # noqa: E402
from repro.launch.server import TraceRecorder as JTraceRecorder  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cache_api import available_policies  # noqa: E402
from repro_torch.launch.batch_engine import BatchEngine, Request  # noqa: E402
from repro_torch.launch.server import (  # noqa: E402
    ServingPipeline,
    SyncServer,
    TraceRecorder,
    make_requests,
)
from repro_torch.launch.server.tracing import (  # noqa: E402
    DEVICE_TID,
    DeviceClock,
)
from repro_torch.launch.server.pipeline import drain_stream  # noqa: E402
from repro_torch.launch.server.stats import (  # noqa: E402
    ServerMetrics,
    sanitize_metric_name,
)
from repro_torch.models.lm import LM  # noqa: E402


def _load_check_trace():
    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "check_trace.py")
    spec = importlib.util.spec_from_file_location("check_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


check_trace = _load_check_trace().check_trace

S_MAX, CAPACITY, PS, CHUNK = 48, 3, 16, 4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    jm = build_model(jget_config("smol-d64"))
    jp = jm.init(jax.random.PRNGKey(0))
    model = LM(get_config("smol-d64"), device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    return jm, jp, model, params


def _mk_engine(model, params, *, policy="bf16", paged=False,
               capacity=CAPACITY, s_max=S_MAX, **kw):
    return BatchEngine(model, params, capacity=capacity, s_max=s_max,
                       policy=policy, backend="gather", chunk=CHUNK,
                       paged=paged, page_size=PS, device="cpu", **kw)


def _requests(model, n, *, policy, new_tokens=4):
    window = getattr(model.cache_policy(policy), "window", 1)
    return make_requests(n, prompt_len=32, new_tokens=new_tokens, seed=0,
                         align=window, run_len=2)


def _masked(export: dict) -> list:
    """The recorded events without their clocks and thread ids."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
            for e in export["traceEvents"] if e["ph"] != "M"]


# --------------------------------------------------------------------------
# the recorder against the reference's
# --------------------------------------------------------------------------
def _drive(rec) -> None:
    with rec.span("ctx", cat="a", k=1):
        pass
    rec.span_at("at", time.perf_counter(), cat="b", rid=5)
    rec.req_mark(9, "submit")
    rec.req_mark(9, "admit")
    rec.req_add(9, "prefill_s", 0.25)
    rec.instant("mark", cat="c", rid=9, pages=3)
    rec.req_mark(9, "first_token")
    rec.req_done(9)
    rec.req_timing(9)
    for i in range(6):
        rec.instant(f"e{i}")


@pytest.mark.parametrize("capacity", [4, 64])
def test_export_equals_reference_with_clocks_masked(capacity):
    port, ref = TraceRecorder(capacity=capacity), JTraceRecorder(
        capacity=capacity)
    _drive(port)
    _drive(ref)
    a, b = port.export(), ref.export()
    assert _masked(a) == _masked(b)
    assert a["otherData"] == b["otherData"]
    assert a["displayTimeUnit"] == b["displayTimeUnit"] == "ms"
    assert (len(port), port.dropped) == (len(ref), ref.dropped)
    assert not check_trace(a)
    off = TraceRecorder(capacity=capacity, enabled=False)
    _drive(off)
    assert off.export()["traceEvents"] == [] and len(off) == 0


def test_capacity_validation_and_ring_drops_oldest():
    for bad in (0, -1):
        with pytest.raises(ValueError, match="capacity"):
            TraceRecorder(capacity=bad)
    tr = TraceRecorder(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    assert len(tr) == 4 and tr.dropped == 6
    assert [e["name"] for e in tr.export()["traceEvents"]
            if e["ph"] == "i"] == ["e6", "e7", "e8", "e9"]
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0


def test_spans_windows_and_thread_tracks(tmp_path):
    tr = TraceRecorder(capacity=64)
    with tr.span("ctx"):
        time.sleep(0.002)
    tr.instant("old")
    time.sleep(0.05)
    tr.instant("new")
    assert [e["dur"] for e in tr.export()["traceEvents"]
            if e["ph"] == "X"][0] >= 1500
    assert [e["name"] for e in tr.export(last_s=0.03)["traceEvents"]
            if e["ph"] == "i"] == ["new"]
    t = threading.Thread(target=lambda: tr.instant("other"),
                         name="trace-test-worker")
    t.start()
    t.join(10)
    assert not t.is_alive()
    evs = tr.export()["traceEvents"]
    assert len({e["tid"] for e in evs if e["ph"] == "i"}) == 2
    meta = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert len(meta) == 2  # a finished thread is named by its id
    assert any("trace-test-worker" in n or "thread-" in n for n in meta)
    n = tr.write(str(tmp_path / "t.json"))
    assert len(json.loads((tmp_path / "t.json").read_text())
               ["traceEvents"]) == n


def test_req_timing_first_mark_wins_and_registry_bound():
    tr = TraceRecorder(capacity=32)
    tr.req_mark(3, "submit")
    time.sleep(0.002)
    tr.req_mark(3, "admit")
    tr.req_add(3, "prefill_s", 0.25)
    tr.req_add(3, "prefill_s", 0.25)
    tr.req_mark(3, "first_token")
    first = tr._req[3]["first_token"]
    tr.req_mark(3, "first_token")  # a preemption resume: the first wins
    assert tr._req[3]["first_token"] == first
    tr.req_done(3)
    timing = tr.req_timing(3)
    assert timing["prefill_s"] == pytest.approx(0.5)
    assert timing["queue_wait_s"] >= 0.001
    assert tr.req_timing(3) is None and tr.req_timing(999) is None
    tr._req_cap = 4
    for rid in range(10):
        tr.req_mark(rid, "submit")
    assert set(tr._req) == {6, 7, 8, 9}


# --------------------------------------------------------------------------
# the engine's span and instant sites against the reference engine's
# --------------------------------------------------------------------------
PORT_ONLY = ("host", "device")  # the port's own span categories


def _engine_events(rec) -> list:
    """The engine-side events in order: names, phases and arguments, less
    the port's own ``host`` and ``device`` spans, which the reference does
    not record."""
    return [(e["name"], e["ph"], e.get("cat"), e.get("args"))
            for e in _masked(rec.export()) if e.get("cat") not in PORT_ONLY]


REF_KW = dict(capacity=2, s_max=S_MAX, policy="bf16", paged=True,
              page_size=PS, prefill_chunk=16, offload_bytes=1 << 20)


def _reference_workload(eng, cls, rec):
    """The workload both engines run for the comparison: three waves of
    requests over a host tier, then ``cancel_all``.  Returns ``rec``."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, 33).astype(np.int32)
    b = rng.integers(0, 256, 20).astype(np.int32)
    waves = [[(0, a, 3)], [(1, a, 5), (2, a, 3)], [(3, b, 9), (4, a, 9)]]
    eng.trace = rec
    for i, wave in enumerate(waves):
        for rid, p, n in wave:
            eng.submit(cls(rid=rid, prompt=p, max_new_tokens=n))
        while eng.has_work and (i < 2 or eng.n_active < 2):
            eng.step()
    eng.cancel_all()
    return rec


def test_engine_records_the_reference_events(lm):
    """Paged chunked admission with a host tier: a request, the same
    prompt again (restored from the tier) and once more while that one is
    resident (a device hit), a new prompt, and cancellations.  The port
    records the reference engine's events in the reference's order:
    submit and request marks, prefix miss / restore / adopt, prefill
    chunks, the spill, decode chunks, steps, retirements."""
    jm, jp, model, params = lm
    want = _engine_events(_reference_workload(
        JBatchEngine(jm, jp, backend="gather", chunk=CHUNK,
                     key=jax.random.PRNGKey(7), **REF_KW), JRequest,
        JTraceRecorder(capacity=4096)))
    got = _engine_events(_reference_workload(
        BatchEngine(model, params, backend="gather", chunk=CHUNK,
                    device="cpu", **REF_KW), Request,
        TraceRecorder(capacity=4096)))
    assert got == want
    names = {n for n, *_ in got}
    for need in ("prefix.miss", "prefix.restore", "prefix.adopt",
                 "offload.spill", "prefill.chunk", "decode.chunk",
                 "engine.step", "req.retire", "request"):
        assert need in names, need


def test_engine_records_packed_preempt_and_spec_sites(lm):
    """The sites no chunked run reaches, within the port: a packed
    prefill (and its per-request prefill time), a preemption in an
    undersized pool, a speculative verify."""
    _, _, model, params = lm
    rec = TraceRecorder(capacity=4096)
    eng = _mk_engine(model, params, policy="bf16", trace=rec)
    a, b = _requests(model, 2, policy="bf16")
    eng.admit_packed([a, b])
    list(eng.run())
    evs = [e for e in rec.export()["traceEvents"]
           if e["name"] == "prefill.packed"]
    assert len(evs) == 1 and evs[0]["args"]["rows"] == 2
    assert evs[0]["args"]["rids"] == [a.rid, b.rid]

    rec = TraceRecorder(capacity=4096)
    eng = _mk_engine(model, params, policy="int4-srft", paged=True,
                     capacity=2, n_pages=4, trace=rec)
    p = np.arange(17, dtype=np.int32)
    list(eng.run([Request(0, p, 10), Request(1, p[:16] + 1, 8)]))
    assert eng.n_preemptions > 0
    pre = [e for e in rec.export()["traceEvents"]
           if e["name"] == "engine.preempt"]
    assert len(pre) == eng.n_preemptions and pre[0]["args"]["pages"] > 0

    rec = TraceRecorder(capacity=4096)
    eng = _mk_engine(model, params, policy="bf16", spec_k=2, trace=rec)
    list(eng.run(_requests(model, 2, policy="bf16", new_tokens=6)))
    spec = [e["args"] for e in rec.export()["traceEvents"]
            if e["name"] == "spec.verify"]
    assert sum(s["drafted"] for s in spec) == eng.n_drafted > 0
    assert sum(s["rejected"] for s in spec) == eng.n_rejected


# --------------------------------------------------------------------------
# the port's own spans: the host's turn between chunks and the device clock
# --------------------------------------------------------------------------
CHUNK_PARTS = ("decode.upload", "decode.enqueue", "decode.readback")
STEP_PARTS = ("step.admit", "step.scatter")


def _spans(rec) -> list:
    return [e for e in rec.export()["traceEvents"] if e["ph"] == "X"]


def _inside(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"])


def _check_host_spans(rec) -> None:
    """Every engine.step holds one step.admit, and, when it decoded, one
    decode.chunk and one step.scatter; every decode.chunk holds one of
    each of its parts; no host span lies outside an engine.step."""
    spans = _spans(rec)
    by = {n: [e for e in spans if e["name"] == n]
          for n in ("engine.step", "decode.chunk", *CHUNK_PARTS,
                    *STEP_PARTS)}
    assert by["engine.step"] and by["decode.chunk"]
    for st in by["engine.step"]:
        inner = {n: [e for e in by[n] if _inside(e, st)] for n in by
                 if n != "engine.step"}
        assert len(inner["step.admit"]) == 1
        n_chunks = len(inner["decode.chunk"])
        assert n_chunks <= 1 and len(inner["step.scatter"]) == n_chunks
        assert all(len(inner[n]) == n_chunks for n in CHUNK_PARTS)
    for ch in by["decode.chunk"]:
        parts = [[e for e in by[n] if _inside(e, ch)] for n in CHUNK_PARTS]
        assert [len(p) for p in parts] == [1, 1, 1]
        # upload, enqueue and readback follow each other in that order
        assert parts[0][0]["ts"] <= parts[1][0]["ts"] <= parts[2][0]["ts"]
    for n in (*CHUNK_PARTS, *STEP_PARTS):
        assert len(by[n]) == sum(1 for e in by[n] if any(
            _inside(e, st) for st in by["engine.step"]))
        assert all(e["cat"] == "host" for e in by[n])
    assert len(by["decode.upload"]) == len(by["decode.chunk"])
    assert len(by["step.admit"]) == len(by["engine.step"])
    # inside a step, prefills are admission's and retirements admission's
    # or the scatter's
    evs = rec.export()["traceEvents"]
    for e in evs:
        if e["name"] not in ("req.retire", "engine.prefill",
                             "prefill.chunk"):
            continue
        e = dict(e, dur=e.get("dur", 0))
        if any(_inside(e, st) for st in by["engine.step"]):
            assert any(_inside(e, h) for h in by["step.admit"]
                       + by["step.scatter"] * (e["name"] == "req.retire")
                       ), e["name"]
    assert not check_trace(rec.export())


def test_engine_records_the_port_only_events(lm):
    """The reference comparison's workload, port alone: the events the
    comparison leaves out (categories ``host`` and ``device``) are there,
    the host spans nest in the reference's spans once per chunk and step,
    and each prefill chunk and decode chunk has its device span."""
    _, _, model, params = lm
    rec = _reference_workload(
        BatchEngine(model, params, backend="gather", chunk=CHUNK,
                    device="cpu", **REF_KW), Request,
        TraceRecorder(capacity=4096))
    _check_host_spans(rec)
    spans = _spans(rec)
    count = {n: sum(1 for e in spans if e["name"] == n)
             for n in ("decode.chunk", "decode.device", "prefill.chunk",
                       "prefill.device")}
    assert count["decode.device"] == count["decode.chunk"] > 0
    assert count["prefill.device"] == count["prefill.chunk"] > 0
    ports = [e for e in spans if e["cat"] in PORT_ONLY]
    assert {e["cat"] for e in ports} == set(PORT_ONLY)
    dev = [e for e in spans if e["cat"] == "device"]
    assert {e["tid"] for e in dev} == {DEVICE_TID}
    assert {e["name"] for e in dev} == {"decode.device", "prefill.device"}


def _by_mode(model, params, mode, rec):
    """Three requests through one admission mode; returns the engine."""
    kw = dict(prefill_chunk=16) if mode == "chunked" else {}
    eng = _mk_engine(model, params, policy="int4-srft", paged=True,
                     trace=rec, **kw)
    reqs = _requests(model, 3, policy="int4-srft", new_tokens=6)
    if mode == "packed":
        eng.admit_packed(reqs[:2])
        # resolved at the first token's readback, before any decode chunk
        assert [e["args"]["rids"] for e in _spans(rec)
                if e["name"] == "prefill.device"] == [[r.rid
                                                       for r in reqs[:2]]]
        reqs = reqs[2:]
    list(eng.run(reqs))
    return eng, [r.rid for r in _requests(model, 3, policy="int4-srft")]


@pytest.mark.parametrize("mode", ["monolithic", "packed", "chunked"])
def test_device_spans_through_the_cpu_fallback(lm, mode):
    """On the CPU a device span's ``dev_ms`` is the host time between its
    marks, so it lies inside the host span it belongs to; every decode
    chunk has a ``decode.device`` with ``gap_ms`` after the first, every
    admission prefill (each chunk of a chunked one) a ``prefill.device``,
    and a request's ``prefill_s`` is the device time of its prefills."""
    _, _, model, params = lm
    rec = TraceRecorder(capacity=1 << 14)
    eng, rids = _by_mode(model, params, mode, rec)
    _check_host_spans(rec)
    spans = _spans(rec)
    chunks = [e for e in spans if e["name"] == "decode.chunk"]
    dev = [e for e in spans if e["name"] == "decode.device"]
    assert len(dev) == len(chunks) > 1
    assert [d["args"]["steps"] for d in dev] == [
        c["args"]["steps"] for c in chunks]
    assert "gap_ms" not in dev[0]["args"]
    for d, c in zip(dev, chunks):
        assert 0 <= d["args"]["dev_ms"] <= c["dur"] / 1e3
        assert d["dur"] == pytest.approx(d["args"]["dev_ms"] * 1e3, abs=1e-2)
    assert all(d["args"]["gap_ms"] >= 0 for d in dev[1:])
    host = {"monolithic": "engine.prefill", "packed": "prefill.packed",
            "chunked": "prefill.chunk"}[mode]
    hosts = [e for e in spans if e["name"] in ("engine.prefill",
                                               "prefill.packed",
                                               "prefill.chunk")]
    pre = [e for e in spans if e["name"] == "prefill.device"]
    assert host in {e["name"] for e in hosts}
    assert len(pre) == len(hosts)
    charged = {rid: 0.0 for rid in rids}
    for p, h in zip(pre, sorted(hosts, key=lambda e: e["ts"])):
        a = p["args"]
        assert 0 <= a["dev_ms"] <= h["dur"] / 1e3 + 1e-9
        assert a["tokens"] == h["args"]["tokens"]
        for rid in a.get("rids", [a.get("rid")]):
            charged[rid] += a["dev_ms"] / 1e3
    if mode == "packed":
        assert [p["args"].get("rids") for p in pre][0] == rids[:2]
    for rid in rids:
        assert rec.req_timing(rid, pop=False)["prefill_s"] == pytest.approx(
            charged[rid], abs=2e-6)
    # the device track is one stream: its spans follow each other
    track = sorted((e for e in spans if e["cat"] == "device"),
                   key=lambda e: e["ts"])
    assert all(a["ts"] + a["dur"] <= b["ts"] + 1e-3
               for a, b in zip(track, track[1:]))
    assert eng._clock.pending == 0


def test_spans_land_on_the_profiler_clock(lm):
    """Under ``torch.profiler``, with the harness's ``engine.step`` range
    around each step: the engine's spans, moved onto the profiler's clock
    by ``profiler_offset_ns``, lie inside that range, and the engine opens
    no ``record_function`` of its own, with or without a profiler (so a
    device trace has no mirror of a program span to count as work)."""
    _, _, model, params = lm
    calls = []

    class Counting(torch.profiler.record_function):
        def __init__(self, name, *a, **k):
            calls.append(name)
            super().__init__(name, *a, **k)

    rec = TraceRecorder(capacity=4096)
    eng = _mk_engine(model, params, policy="int4-srft", paged=True,
                     trace=rec)
    for r in _requests(model, 2, policy="int4-srft", new_tokens=13):
        eng.submit(r)
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.profiler, "record_function", Counting)
    mp.setattr(torch.autograd.profiler, "record_function", Counting)
    try:
        eng.step()
        assert calls == []
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                with Counting("engine.step"):
                    eng.step()
    finally:
        mp.undo()
    assert calls == ["engine.step"] * 2
    off = TraceRecorder.profiler_offset_ns()
    ranges = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.name() == "engine.step")
    assert len(ranges) == 2
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    spans = [e for e in _spans(rec) if e["cat"] != "device"]
    assert not names & {e["name"] for e in spans} - {"engine.step"}
    steps = [e for e in spans if e["name"] == "engine.step"][1:]
    assert len(steps) == 2
    for (a, b), st in zip(ranges, steps):
        inner = [e for e in spans if _inside(e, st)]
        assert {"decode.chunk", *CHUNK_PARTS, *STEP_PARTS} <= {
            e["name"] for e in inner}
        for e in inner:
            t0 = round((rec.t0 + e["ts"] / 1e6) * 1e9) + off
            t1 = t0 + round(e["dur"] * 1e3)
            assert a <= t0 <= t1 <= b, (e["name"], a - t0, b - t1)


class _FakeEvent:
    """A CUDA event's calls on a fake clock: ``record`` stamps the
    stream's time, ``query`` says whether the stream has reached it."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.at = None

    def record(self, stream):
        self.at = stream.now
        stream.records += 1

    def query(self):
        return self.at <= _FakeCuda.stream.done

    def elapsed_time(self, other):
        assert self.query() and other.query()
        return other.at - self.at


class _FakeCuda:
    class stream:
        now = done = 0.0
        records = 0

    Event = _FakeEvent

    @staticmethod
    def current_stream(device):
        return _FakeCuda.stream


def test_device_clock_pools_events_and_waits_for_completion():
    """The CUDA branch of ``DeviceClock`` on fake events: a span resolves
    only once its end event has completed, in order; ``gap_ms`` runs
    from the previous gap span's end; events come back to the pool, so a
    steady loop makes none; ``charge`` adds to ``prefill_s``."""
    clock = DeviceClock(torch.device("cpu"))
    clock._events = _FakeCuda
    clock._free = [_FakeEvent(enable_timing=True) for _ in range(6)]
    made = _FakeEvent.made
    s = _FakeCuda.stream
    rec = TraceRecorder(capacity=64)
    rec.req_mark(7, "submit")
    for i in range(5):
        s.now = 10.0 * i
        start = clock.mark()
        s.now += 3.0
        clock.push("decode.device", start, clock.mark(), gap=True, steps=8)
        if i == 1:
            s.now += 1.0
            a = clock.mark()
            s.now += 2.0
            clock.push("prefill.device", a, clock.mark(), charge=(7,),
                       rid=7, tokens=4)
            s.done = s.now - 1.0  # the prefill has not ended yet
            clock.resolve(rec)
            assert clock.pending == 1
        s.done = s.now
        clock.resolve(rec)
        assert clock.pending == 0
    # the last chunk's end event stays out for the next gap
    assert _FakeEvent.made == made and len(clock._free) == 5
    dev = [e["args"] for e in _spans(rec) if e["name"] == "decode.device"]
    assert [d["dev_ms"] for d in dev] == [3.0] * 5
    assert [d.get("gap_ms") for d in dev] == [None, 7.0, 7.0, 7.0, 7.0]
    pre = [e for e in _spans(rec) if e["name"] == "prefill.device"]
    assert len(pre) == 1 and pre[0]["args"]["dev_ms"] == 2.0
    assert rec.req_timing(7)["prefill_s"] == pytest.approx(0.002)
    for _ in range(6):  # one mark more than the pool holds: one more event
        clock.mark()
    assert _FakeEvent.made == made + 1


# --------------------------------------------------------------------------
# zero interference and exported structure
# --------------------------------------------------------------------------
def _traced_run(model, params, reqs, *, policy, paged, enabled):
    eng = _mk_engine(model, params, policy=policy, paged=paged)
    trace = TraceRecorder(capacity=1 << 14, enabled=enabled)
    pipe = ServingPipeline(eng, max_group=eng.capacity,
                           admit_queue=max(len(reqs), 8), trace=trace)
    assert eng.trace is trace
    streams = {r.rid: pipe.submit(r) for r in reqs}
    pipe.start()
    out = {rid: drain_stream(q, timeout=120.0) for rid, q in streams.items()}
    assert pipe.shutdown(timeout=60.0)
    return out, trace


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("policy", available_policies())
def test_streams_identical_tracing_on_off(lm, policy, paged):
    _, _, model, params = lm
    reqs = _requests(model, 6, policy=policy)
    on, trace = _traced_run(model, params, reqs, policy=policy, paged=paged,
                            enabled=True)
    off, _ = _traced_run(model, params, reqs, policy=policy, paged=paged,
                         enabled=False)
    assert on == off
    assert len(trace) > 0 and trace.dropped == 0


def test_pipeline_trace_validates_and_carries_timing(lm):
    _, _, model, params = lm
    reqs = _requests(model, 4, policy="int4-srft")
    eng = _mk_engine(model, params, policy="int4-srft", paged=True)
    trace = TraceRecorder(capacity=1 << 14)
    pipe = ServingPipeline(eng, max_group=eng.capacity, admit_queue=8,
                           trace=trace)
    streams = {r.rid: pipe.submit(r) for r in reqs}
    pipe.start()
    finals = {}
    for rid, q in streams.items():
        while True:
            ev = q.get(timeout=120.0)
            if ev.finish_reason is not None:
                finals[rid] = ev
                break
    assert pipe.shutdown(timeout=60.0)
    for rid, final in finals.items():
        assert final.finish_reason == "length"
        assert set(final.timing) == {"queue_wait_s", "prefill_s",
                                     "decode_s", "detok_s", "total_s"}
        assert all(v >= 0 for v in final.timing.values())
        assert final.timing["prefill_s"] > 0
        assert json.loads(final.sse)["timing"] == final.timing
    out = trace.export()
    problems = check_trace(out)
    assert not problems, "\n".join(problems)
    names = {e["name"] for e in out["traceEvents"]}
    for need in ("request", "req.submit", "tok.stream", "detok",
                 "engine.step", "decode.chunk", "req.retire",
                 "prefill.packed", "admit.group", "admit.sweep"):
        assert need in names, f"missing {need!r} (have {sorted(names)})"
    tids = {name: {e["tid"] for e in out["traceEvents"] if e["name"] == name}
            for name in ("admit.sweep", "engine.step", "detok")}
    assert all(len(t) == 1 for t in tids.values())  # one stage thread each
    assert len(set.union(*tids.values())) == 3
    ids = {r.rid for r in reqs}
    assert {e["id"] for e in out["traceEvents"] if e["ph"] == "b"} == ids
    assert {e["id"] for e in out["traceEvents"] if e["ph"] == "e"} == ids


def test_sync_server_and_pipeline_share_the_recorder(lm):
    _, _, model, params = lm
    eng = _mk_engine(model, params, policy="bf16")
    srv = SyncServer(eng, max_group=eng.capacity)
    assert srv.trace.enabled and eng.trace is srv.trace
    streams = {r.rid: srv.submit(r)
               for r in _requests(model, 2, policy="bf16")}
    srv.run_until_drained()
    for q in streams.values():
        drain_stream(q, timeout=10.0)
    srv.close()
    assert not check_trace(srv.trace.export())
    mine = TraceRecorder(capacity=128)
    eng.trace = mine
    assert ServingPipeline(eng, admit_queue=4).trace is mine  # adopted
    eng.step_listeners.clear()
    eng2 = _mk_engine(model, params, policy="bf16")
    assert not eng2.trace.enabled  # the engine's default
    pipe2 = ServingPipeline(eng2, admit_queue=4)
    assert pipe2.trace.enabled and eng2.trace is pipe2.trace
    off = TraceRecorder(capacity=1, enabled=False)
    assert ServingPipeline(eng2, admit_queue=4, trace=off).trace is off
    eng2.step_listeners.clear()


def test_prefix_store_records_disk_traffic(lm, tmp_path):
    """With a disk tier behind a RAM budget of one page, the first of two
    spilled pages goes to disk and comes back on the restore:
    ``store.spill`` / ``store.load`` instants in the engine's recorder."""
    _, _, model, params = lm
    cfg = model.cfg
    page = cfg.n_layers * 2 * cfg.n_kv_heads * PS * cfg.head_dim * 2
    rec = TraceRecorder(capacity=4096)
    eng = _mk_engine(model, params, policy="bf16", paged=True,
                     prefill_chunk=16, offload_bytes=page,
                     offload_dir=str(tmp_path), trace=rec)
    assert eng.prefix_store.trace is rec
    p = np.arange(33, dtype=np.int32)
    for rid in (0, 1):
        list(eng.run([Request(rid, p, 2)]))
    names = [e["name"] for e in rec.export()["traceEvents"]]
    assert "store.spill" in names and "store.load" in names
    assert eng.n_reuse_hits_host == 1


# --------------------------------------------------------------------------
# strict /metrics
# --------------------------------------------------------------------------
def _parse_prometheus_strict(text):
    """Every sample belongs to a family declared by HELP and TYPE above
    it, and every name matches the Prometheus charset."""
    name_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    families, helped, n = {}, set(), 0
    for line in text.strip().split("\n"):
        if line.startswith("# HELP "):
            fam = line.split()[2]
            assert name_re.match(fam), fam
            helped.add(fam)
        elif line.startswith("# TYPE "):
            _, _, fam, typ = line.split(None, 3)
            assert typ in ("counter", "gauge", "summary", "histogram")
            assert fam in helped, f"TYPE before HELP for {fam}"
            families[fam] = typ
        else:
            assert not line.startswith("#"), line
            sample = re.split(r"[{\s]", line, maxsplit=1)[0]
            assert name_re.match(sample), sample
            base = sample
            for suffix in ("_count", "_sum"):
                if sample.endswith(suffix) and \
                        sample[:-len(suffix)] in families:
                    base = sample[:-len(suffix)]
            assert base in families, f"undeclared family for {line!r}"
            float(line.rsplit(None, 1)[1])
            n += 1
    return families, n


def test_metrics_text_is_strict_prometheus(lm):
    _, _, model, params = lm
    eng = _mk_engine(model, params, policy="int4-srft", paged=True)
    reqs = _requests(model, 3, policy="int4-srft")
    pipe = ServingPipeline(eng, max_group=eng.capacity, admit_queue=8)
    streams = {r.rid: pipe.submit(r) for r in reqs}
    pipe.start()
    for q in streams.values():
        drain_stream(q, timeout=120.0)
    assert pipe.shutdown(timeout=60.0)
    text = pipe.metrics_text()
    families, n = _parse_prometheus_strict(text)
    assert n > 10
    assert families["server_requests_completed_total"] == "counter"
    assert families["server_ttft_seconds"] == "summary"
    assert families["server_slots_active"] == "gauge"
    assert families["server_trace_dropped_total"] == "counter"
    assert families["server_prefix_tier_requests_total"] == "counter"
    assert "server_requests_completed_total 3" in text
    assert 'server_prefix_tier_requests_total{outcome="length"' in text
    assert sanitize_metric_name("bad-name.x") == "bad_name_x"
    assert sanitize_metric_name("0starts") == "_0starts"
    assert "# TYPE server_x counter" in ServerMetrics().render_prometheus(
        labeled={"x": ("counter", "h", [({"a": "1"}, 2)])})
