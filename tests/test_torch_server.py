"""The serving front-end (``repro_torch.launch.server``, ``launch/serve.py``)
against ``repro.launch.server`` on the same requests, weights and
rotations (bridged), and the invariants the reference proves within
itself, proven within the port.  CPU, smol-d64, ``S_MAX`` 48, capacity 3,
plain kernel versions.

Tolerances.  Across the two packages, the port's ``SyncServer`` streams
equal the reference's, except where the reference's top-2 logit gap at
the first diverging step (its single-stream logits, teacher-forced) is
below LOGIT_TOL of its largest logit, as ``test_torch_batch_engine.py``
judges it.  The seeded workload (prompts and arrival times), the
bucketizer's groups, the Prometheus text and the histogram summaries are
equal exactly.  Within the port, pipelined == sync bit for bit for every
policy and layout: closed-loop submission pins the packed-prefill
grouping, and a batch-k prefill's rows do not depend on which slots they
land in."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import re  # noqa: E402
import threading  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.batch_engine import BatchEngine as JBatchEngine  # noqa: E402
from repro.launch.server import BucketedAdmission as JBucketedAdmission  # noqa: E402
from repro.launch.server import Histogram as JHistogram  # noqa: E402
from repro.launch.server import ServerMetrics as JServerMetrics  # noqa: E402
from repro.launch.server import SyncServer as JSyncServer  # noqa: E402
from repro.launch.server import make_requests as jmake_requests  # noqa: E402
from repro.launch.server import make_trace as jmake_trace  # noqa: E402
from repro.launch.server.pipeline import drain_stream as jdrain_stream  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cache_api import available_policies  # noqa: E402
from repro_torch.core.paged import NULL_PAGE  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.batch_engine import BatchEngine, Request  # noqa: E402
from repro_torch.launch.engine import Sampler  # noqa: E402
from repro_torch.launch.server import (  # noqa: E402
    Backpressure,
    BucketedAdmission,
    CompletionServer,
    Histogram,
    ServerMetrics,
    ServingPipeline,
    SyncServer,
    bucket_lengths,
    cache_report_data,
    make_requests,
    make_trace,
)
from repro_torch.launch.server.pipeline import TokenFanout, drain_stream  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

LOGIT_TOL = 0.05
S_MAX, CAPACITY, PS, CHUNK = 48, 3, 16, 4
KEY = jax.random.PRNGKey(7)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Tiny ops: intra-op threads only add contention between test
    workers.  Restored afterwards."""
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


def _requests(model, n, *, policy, new_tokens=6, make=make_requests):
    window = getattr(model.cache_policy(policy), "window", 1)
    return make(n, prompt_len=32, new_tokens=new_tokens, seed=0,
                align=window, run_len=2)


def _sync_streams(engine, reqs, server=SyncServer, drain=drain_stream):
    srv = server(engine, max_group=engine.capacity)
    streams = {r.rid: srv.submit(r) for r in reqs}
    srv.run_until_drained()
    out = {rid: drain(q, timeout=10.0) for rid, q in streams.items()}
    srv.close()
    return out


def _pipeline_streams(engine, reqs):
    # closed loop: everything queued before the stage threads start, so
    # the admission sweep forms the groups the sync loop forms
    pipe = ServingPipeline(engine, max_group=engine.capacity,
                           admit_queue=max(len(reqs), 8))
    streams = {r.rid: pipe.submit(r) for r in reqs}
    pipe.start()
    out = {rid: drain_stream(q, timeout=120.0) for rid, q in streams.items()}
    assert pipe.shutdown(timeout=60.0)
    return out


def _rots(jeng):
    d = jeng.cache["attn"].data
    if not hasattr(d, "rot_k"):
        return None
    return bridge.rotations({
        side: {f: np.asarray(getattr(getattr(d, f"rot_{side}"), f))
               for f in ("matrix", "lam", "signs")}
        for side in ("k", "v")})


def _jax_logits(jm, jp, policy, prompt, toks):
    """The reference's single-stream logits of one request, teacher-forced
    on ``toks``, under the engine's rotations (same key): called only
    where the streams part."""

    def at():
        cache = jm.init_cache(1, S_MAX, policy=policy, key=KEY)
        logits, cache = jm.prefill(
            jp, jnp.asarray(np.asarray(prompt)[None], jnp.int32), cache)
        out = [np.asarray(logits[0, -1])]
        for t in toks[:-1]:
            logits, cache = jm.decode_step(
                jp, jnp.asarray([[t]], jnp.int32), cache, backend="gather")
            out.append(np.asarray(logits[0, -1]))
        return np.stack(out)

    return at


def _agree_up_to_tie(ref, got, logits_at, what):
    assert len(ref) == len(got), what
    diff = np.nonzero(np.asarray(ref) != np.asarray(got))[0]
    if not len(diff):
        return
    i = int(diff[0])
    logits = logits_at()
    top2 = np.sort(np.asarray(logits[i], np.float32))[-2:]
    tol = LOGIT_TOL * np.abs(logits).max()
    assert top2[1] - top2[0] < tol, (
        f"{what}: tokens diverge at step {i} with a top-2 gap of "
        f"{top2[1] - top2[0]} >= {tol}")


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_sync_server_matches_reference(lm, policy):
    """One seeded queue through both packages' ``SyncServer`` (packed
    admission, capacity 3, so groups of 2 and a slot reused): every
    stream's finish reason equal, its tokens equal up to a near-tie."""
    jm, jp, model, params = lm
    jeng = JBatchEngine(jm, jp, capacity=CAPACITY, s_max=S_MAX,
                        policy=policy, backend="gather", chunk=CHUNK, key=KEY)
    want = _sync_streams(jeng, _requests(model, 6, policy=policy,
                                         make=jmake_requests),
                         server=JSyncServer, drain=jdrain_stream)
    reqs = _requests(model, 6, policy=policy)
    got = _sync_streams(_mk_engine(model, params, policy=policy,
                                   rots=_rots(jeng)), reqs)
    assert set(got) == set(want)
    for r in reqs:
        (t_w, f_w), (t_g, f_g) = want[r.rid], got[r.rid]
        assert f_w == f_g == "length" and len(t_g) == 6
        _agree_up_to_tie(t_w, t_g, _jax_logits(jm, jp, policy, r.prompt,
                                               t_w), f"{policy} rid {r.rid}")


@pytest.mark.parametrize("kw", [
    dict(n=6, prompt_len=32, new_tokens=4, run_len=2),
    dict(n=5, prompt_len=50, new_tokens=3, align=16, seed=3),
    dict(n=4, prompt_len=1, new_tokens=2),
])
def test_workload_equals_reference(kw):
    """``make_requests`` and ``make_trace`` under every arrival process:
    the reference's prompts (as int32), budgets, rids and times."""
    for arrival in ("closed", "poisson", "bursty"):
        want = jmake_trace(**kw, arrival=arrival, rate=50.0, burst=2)
        got = make_trace(**kw, arrival=arrival, rate=50.0, burst=2)
        assert [it.arrival_s for it in got] == [it.arrival_s for it in want]
        for a, b in zip(got, want):
            assert (a.req.rid, a.req.max_new_tokens) == \
                (b.req.rid, b.req.max_new_tokens)
            assert a.req.prompt.dtype == np.int32
            np.testing.assert_array_equal(a.req.prompt,
                                          np.asarray(b.req.prompt))
    assert len(make_requests(**kw)) == kw["n"]


def test_metrics_text_and_summaries_equal_reference():
    """The same samples give the reference's Prometheus text and
    histogram summaries, past the reservoir cap too."""
    port, ref = ServerMetrics(), JServerMetrics()
    rng = np.random.default_rng(0)
    for m in (port, ref):
        m.received, m.rejected, m.completed = 7, 1, 5
        m.cancelled, m.tokens_streamed = 1, 123
    for x in rng.exponential(0.05, 300):
        for m in (port, ref):
            m.ttft.record(x)
            m.itl.record(x / 7)
            m.e2e.record(3 * x)
    gauges = {"slots_active": 3, "pool_utilization": 0.25,
              "bad-name.x": 2, "trace_dropped_total": 0}
    labeled = {"prefix_tier_requests_total": (
        "counter", "by tier", [({"tier": "host", "outcome": 'q"t'}, 2)])}
    assert port.render_prometheus(gauges, labeled) == \
        ref.render_prometheus(gauges, labeled)
    assert port.snapshot() == ref.snapshot()
    h, jh = Histogram(cap=64), JHistogram(cap=64)
    for i in range(5000):
        h.record(i * 0.001)
        jh.record(i * 0.001)
    assert h.summary() == jh.summary()


class _FakeEngine:
    """What a bucketizer reads and calls, for both packages' bucketizers:
    it records the groups it is handed and frees no slot."""

    def __init__(self, trace, capacity=4, free=4):
        self.capacity, self.prefill_chunk = capacity, None
        self.n_free_slots, self.groups = free, []
        self.lock, self.trace = threading.RLock(), trace

    def admit_packed(self, group):
        self.groups.append([r.rid for r in group])
        self.n_free_slots -= len(group)


def test_bucketizer_groups_equal_reference():
    """Head groups of exact equal lengths, capped at ``max_group``, and a
    group that waits whole while the free slots are too few: the
    reference's groups on the same arrivals and slot counts."""
    from repro.launch.server import TraceRecorder as JTraceRecorder
    from repro_torch.launch.server import TraceRecorder

    lens = (8, 8, 8, 12, 12, 8, 16, 16, 16, 16, 8)
    runs = []
    for buck_cls, rec in ((BucketedAdmission, TraceRecorder),
                          (JBucketedAdmission, JTraceRecorder)):
        eng = _FakeEngine(rec(enabled=False))
        buck = buck_cls(eng, max_group=3)
        assert buck.head_group_len() == 0
        for i, n in enumerate(lens):
            buck.offer(Request(rid=i, prompt=np.zeros(n, np.int32),
                               max_new_tokens=2))
        heads, moved = [], []
        for free in (4, 1, 3, 0, 4, 4):
            eng.n_free_slots = free
            heads.append(buck.head_group_len())
            moved.append(buck.admit())
        runs.append((eng.groups, heads, moved, buck.n_groups, buck.n_packed,
                     buck.depth))
    assert runs[0] == runs[1]
    assert runs[0][0][0] == [0, 1, 2]


# --------------------------------------------------------------------------
# within the port: the pipeline reorders host work, never device work
# --------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("policy", available_policies())
def test_pipelined_streams_bit_identical_to_sync(lm, policy, paged):
    _, _, model, params = lm
    reqs = _requests(model, 6, policy=policy)
    ref = _sync_streams(_mk_engine(model, params, policy=policy, paged=paged),
                        reqs)
    got = _pipeline_streams(
        _mk_engine(model, params, policy=policy, paged=paged), reqs)
    assert got == ref
    for toks, reason in ref.values():
        assert reason == "length" and len(toks) == 6


def test_packed_admission_is_deterministic_and_order_free(lm):
    """Two packed admissions of the same pair, in either row order, give
    the same streams; mixed lengths and too few slots are refused."""
    _, _, model, params = lm
    eng = _mk_engine(model, params, policy="int4-srft", capacity=2)
    a, b = _requests(model, 2, policy="int4-srft")
    assert len(a.prompt) == len(b.prompt)
    runs = []
    for order in ((a, b), (b, a), (a, b)):
        events = {}

        def listen(evs, comps, _store=events):
            for rid, toks in evs:
                _store.setdefault(rid, []).extend(toks)

        eng.step_listeners.append(listen)
        eng.admit_packed([Request(rid=r.rid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens)
                          for r in order])
        while eng.has_work:
            eng.step()
        eng.step_listeners.remove(listen)
        runs.append(events)
    assert runs[0] == runs[1] == runs[2]
    assert all(len(t) == 6 for t in runs[0].values())
    eng.admit_packed([])  # a no-op
    assert not eng.has_work
    with pytest.raises(ValueError, match="length"):
        eng.admit_packed([Request(0, np.zeros(8, np.int32), 2),
                          Request(1, np.zeros(12, np.int32), 2)])
    with pytest.raises(ValueError, match="slots"):
        eng.admit_packed([Request(i, np.zeros(8, np.int32), 2)
                          for i in range(3)])


@pytest.mark.parametrize("policy", available_policies())
def test_packed_rows_slice_like_a_batch1_row(lm, policy):
    """``_slice_row`` finds every staging leaf's batch axis (none for the
    rotations) and gives views shaped as a batch-1 staging row's."""
    _, _, model, params = lm
    eng = _mk_engine(model, params, policy=policy)
    staged = model.init_cache(2, S_MAX, policy=policy, rots=eng._rots,
                              ragged=True)
    one = model.init_cache(1, S_MAX, policy=policy, rots=eng._rots,
                           ragged=True)
    row = eng._slice_row(staged, 1)
    from repro_torch.launch.batch_engine import _leaves

    got, want = list(_leaves(row)), list(_leaves(one))
    assert [t.shape for t in got] == [t.shape for t in want]
    assert all(a is b for a, b, ax in zip(
        _leaves(row["attn"][0]), _leaves(staged["attn"][0]),
        eng._row_slice_axes()) if ax is None)
    if policy == "int4-srft":
        assert eng._row_slice_axes().count(None) == 6  # two rotations


def test_packed_admission_requeues_the_tail_when_the_pool_runs_dry(lm):
    """Paged, a pool with room for one row: the first row is inserted, the
    second requeued at the front, and both complete in full."""
    _, _, model, params = lm
    eng = _mk_engine(model, params, policy="bf16", paged=True, capacity=2,
                     n_pages=S_MAX // PS + 1)
    a, b = _requests(model, 2, policy="bf16")
    eng.admit_packed([a, b])
    assert eng.n_active == 1 and eng.pending == 1
    done = {c.rid: c for c in eng.run()}
    assert {len(c.tokens) for c in done.values()} == {6}
    assert eng.pool_stats()["pages_used"] == 0


# --------------------------------------------------------------------------
# backpressure and intake validation
# --------------------------------------------------------------------------
def test_backpressure_rejects_before_engine_touch(lm):
    """A rejected submit consumes nothing engine-side: the generator's
    state, the queue, the slots; a draining server rejects too, and the
    Retry-After grows with the backlog."""
    _, _, model, params = lm
    eng = _mk_engine(model, params, policy="bf16",
                     sampler=Sampler(temperature=0.8),
                     generator=torch.Generator().manual_seed(3))
    state = eng.generator.get_state().clone()
    pipe = ServingPipeline(eng, admit_queue=2)  # never started
    reqs = _requests(model, 3, policy="bf16")
    pipe.submit(reqs[0])
    pipe.submit(reqs[1])
    with pytest.raises(Backpressure, match="full") as exc:
        pipe.submit(reqs[2])
    assert isinstance(exc.value.retry_after, int)
    assert exc.value.retry_after >= 1
    assert pipe.fanout.open_streams == 2
    snap = pipe.metrics.snapshot()
    assert (snap["requests_received"], snap["requests_rejected"]) == (2, 1)
    assert torch.equal(eng.generator.get_state(), state)
    assert not eng.has_work and eng.n_free_slots == CAPACITY
    pipe._closing = True
    pipe.admit_hold_s = 2.0
    with pytest.raises(Backpressure, match="draining") as exc:
        pipe.submit(reqs[2])
    assert exc.value.retry_after >= 4  # 2 queued x 2 s
    eng.step_listeners.clear()


def test_rejected_request_draws_nothing(lm):
    """With a temperature sampler, accepted streams are equal whether or
    not a rejected request arrived between them."""
    _, _, model, params = lm
    reqs = _requests(model, 3, policy="int4-srft")
    extra = Request(rid=99, prompt=reqs[0].prompt,
                    max_new_tokens=reqs[0].max_new_tokens)

    def run(with_reject):
        eng = _mk_engine(model, params, policy="int4-srft",
                         sampler=Sampler(temperature=0.8),
                         generator=torch.Generator().manual_seed(3))
        pipe = ServingPipeline(eng, admit_queue=3)
        streams = {r.rid: pipe.submit(r) for r in reqs}
        if with_reject:
            with pytest.raises(Backpressure):
                pipe.submit(extra)
        pipe.start()
        out = {rid: drain_stream(q, timeout=120.0)
               for rid, q in streams.items()}
        assert pipe.shutdown(timeout=60.0)
        return out

    assert run(False) == run(True)


def test_submit_validates_at_intake(lm):
    _, _, model, params = lm
    pipe = ServingPipeline(_mk_engine(model, params, policy="bf16"))
    with pytest.raises(ValueError, match="s_max"):
        pipe.submit(Request(rid=0, prompt=np.zeros(8, np.int32),
                            max_new_tokens=S_MAX))
    with pytest.raises(ValueError, match="empty"):
        pipe.submit(Request(rid=1, prompt=np.zeros(0, np.int32),
                            max_new_tokens=2))
    assert pipe.fanout.open_streams == 0
    assert pipe.queue_depths()["admit_queue_depth"] == 0
    pipe.engine.step_listeners.clear()


# --------------------------------------------------------------------------
# shutdown: drain and cancel leave nothing behind
# --------------------------------------------------------------------------
def test_cancel_shutdown_returns_every_page(lm):
    _, _, model, params = lm
    eng = _mk_engine(model, params, policy="int4-srft", paged=True,
                     capacity=2)
    reqs = _requests(model, 4, policy="int4-srft", new_tokens=8)
    pipe = ServingPipeline(eng, admit_queue=8)
    streams = {r.rid: pipe.submit(r) for r in reqs}
    admitted = threading.Event()
    eng.step_listeners.append(lambda evs, comps: admitted.set())
    pipe.start()
    assert admitted.wait(120), "the engine never picked the work up"
    pipe.shutdown(cancel=True, timeout=60.0)
    finished = {rid: drain_stream(q, timeout=10.0)
                for rid, q in streams.items()}
    assert pipe.fanout.open_streams == 0
    reasons = [reason for _, reason in finished.values()]
    assert set(reasons) <= {"cancelled", "length"}
    assert "cancelled" in reasons
    rc = eng._refcount_host.copy()
    assert rc[NULL_PAGE] == 1
    rc[NULL_PAGE] = 0
    assert (rc == 0).all(), f"leaked pages: {np.nonzero(rc)[0]}"
    assert eng.n_free_slots == eng.capacity and not eng.has_work
    assert eng.pool_stats()["pages_used"] == 0


# --------------------------------------------------------------------------
# HTTP/SSE (in-process, ephemeral port, stdlib client)
# --------------------------------------------------------------------------
def _post(url, body, timeout=120.0):
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _sse_tokens(resp):
    toks, events = [], []
    for raw in resp:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        payload = line[len("data: "):]
        if payload == "[DONE]":
            return toks, events
        ev = json.loads(payload)
        events.append(ev)
        toks.extend(ev["tokens"])
    raise AssertionError("stream ended without [DONE]")


def test_http_sse_round_trip(lm):
    _, _, model, params = lm
    eng = _mk_engine(model, params, policy="int4-srft", capacity=2)
    pipe = ServingPipeline(eng, admit_queue=8).start()
    server = CompletionServer(pipe, port=0, vocab_size=model.cfg.vocab_size)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = server.url
    try:
        with _post(url, {"prompt": "hello", "max_tokens": 4,
                         "stream": True}) as resp:
            assert resp.headers["Content-Type"].startswith(
                "text/event-stream")
            toks, events = _sse_tokens(resp)
        assert len(toks) == 4 and events[-1]["finish_reason"] == "length"
        assert [e["finish_reason"] for e in events[:-1]] == \
            [None] * (len(events) - 1)
        assert set(events[-1]["timing"]) == {
            "queue_wait_s", "prefill_s", "decode_s", "detok_s", "total_s"}
        with _post(url, {"prompt": [104, 101, 108, 108, 111],
                         "max_tokens": 4}) as resp:
            body = json.loads(resp.read())
        assert body["tokens"] == toks  # the same bytes as token ids
        assert body["finish_reason"] == "length"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["slots_capacity"] == 2
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            metrics = resp.read().decode()
        assert "server_requests_completed_total 2" in metrics
        with urllib.request.urlopen(url + "/debug/trace?last_s=60",
                                    timeout=30) as resp:
            trace = json.loads(resp.read())
        assert trace["otherData"]["window_s"] == 60.0
        for bad in ({"prompt": "hello", "max_tokens": 10_000},
                    {"prompt": []}):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(url, bad).read()
            assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url + "/debug/trace?last_s=x", timeout=30)
        assert exc.value.code == 400
        pipe._closing = True  # a draining server answers 429 + Retry-After
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(url, {"prompt": "hi", "max_tokens": 2}).read()
        assert exc.value.code == 429
        assert int(exc.value.headers["Retry-After"]) >= 1
    finally:
        server.shutdown()
        assert pipe.shutdown(timeout=60.0)


# --------------------------------------------------------------------------
# shared plumbing: fan-out, reports, the CLI
# --------------------------------------------------------------------------
def test_bucket_lengths_align_up():
    assert bucket_lengths(64) == [32, 48, 64]
    assert bucket_lengths(50, align=16) == [32, 48, 64]
    assert bucket_lengths(512) == [256, 384, 512]
    assert bucket_lengths(1) == [1]
    with pytest.raises(ValueError):
        make_requests(2, prompt_len=32, new_tokens=4, run_len=0)
    with pytest.raises(ValueError, match="arrival"):
        make_trace(2, prompt_len=16, new_tokens=2, arrival="uniform")


def test_token_fanout_sse_events_and_metrics():
    metrics = ServerMetrics()
    fan = TokenFanout(metrics)
    q = fan.register(7, t_arrival=0.0)
    with pytest.raises(ValueError, match="duplicate"):
        fan.register(7, t_arrival=0.0)
    fan.process([(7, [65, 66])], [], t=0.5)
    ev = q.get_nowait()
    assert (ev.tokens, ev.text, ev.finish_reason) == ([65, 66], "AB", None)
    assert json.loads(ev.sse) == {"rid": 7, "tokens": [65, 66], "text": "AB",
                                  "finish_reason": None}

    class _C:
        rid, finish_reason = 7, "length"

    fan.process([], [_C], t=1.0)
    assert q.get_nowait().finish_reason == "length"
    assert fan.open_streams == 0
    snap = metrics.snapshot()
    assert snap["tokens_streamed"] == 2 and snap["requests_completed"] == 1
    assert snap["ttft_s"]["p50"] == 0.5 and snap["e2e_s"]["p50"] == 1.0
    q2 = fan.register(8, t_arrival=0.0)
    fan.close_all("cancelled")
    assert q2.get_nowait().finish_reason == "cancelled"
    assert metrics.snapshot()["requests_cancelled"] == 1


def test_cache_report_data_and_pool_metrics(lm):
    """The report reads the port's per-layer states (bytes summed over
    layers); a paged engine with a host tier puts its pool, host bytes
    and offload counters into the report and into /metrics."""
    _, _, model, params = lm
    assert cache_report_data(None, None) == {"kv_applicable": False}
    eng = _mk_engine(model, params, policy="int4-srft")
    data = cache_report_data(eng.policy, eng.cache["attn"], engine=eng)
    assert data["policy"] == "int4-srft" and data["layout"] == "slot cache"
    assert data["compression_ratio"] == pytest.approx(3.2)
    assert data["persistent_bytes"] == sum(
        st.nbytes() for st in eng.cache["attn"])
    eng = _mk_engine(model, params, policy="int4-srft", paged=True,
                     prefill_chunk=16, offload_bytes=1 << 20)
    for _ in eng.run([Request(rid=0, prompt=np.zeros(32, np.int32),
                              max_new_tokens=4)]):
        pass
    data = cache_report_data(eng.policy, eng.cache["attn"], engine=eng)
    assert data["layout"] == "paged pool" and data["prefill_chunks"] == 2
    off = data["pool"]["offload"]
    assert off["enabled"] and off["spilled_pages"] == 2
    text = ServingPipeline(eng).metrics_text()  # never started
    assert "server_offload_spilled_pages_total 2" in text
    assert "server_prefix_hits_host_total 0" in text
    assert re.search(r"^server_host_bytes_total \d+$", text, re.M)
    eng.step_listeners.clear()


def test_serve_cli_closed_loop_and_refusals(tmp_path, capsys):
    """``python -m repro_torch.launch.serve`` on the CPU: the closed-loop
    queue (paged int4, calibrated lambda), its stats and trace files;
    ``--mesh 2`` on a one-device host exits with the reference's message,
    which says how to build a simulated mesh."""
    stats, trace = tmp_path / "s.json", tmp_path / "t.json"
    serve.main(["--arch", "smol-d64", "--device", "cpu", "--paged",
                "--policy", "int4-srft", "--backend", "kernel",
                "--max-batch", "2", "--requests", "3", "--prompt-len", "24",
                "--new-tokens", "4", "--calibrate", "--stats-json",
                str(stats), "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "[calibrate]" in out and out.count("[done]") == 3
    data = json.loads(stats.read_text())
    assert data["requests_done"] == 3 and data["tokens"] == 12
    assert data["cache"]["compression_ratio"] == pytest.approx(3.2)
    assert data["cache"]["pool"]["pages_used"] == 0
    assert len(data["timings"]) == 3
    assert json.loads(trace.read_text())["otherData"]["dropped"] == 0
    with pytest.raises(SystemExit, match="1 visible.*make_mesh"):
        serve.main(["--arch", "smol-d64", "--device", "cpu", "--mesh", "2"])


def test_calibrate_lambdas_matches_static_lambda(lm):
    """Each layer's lambda is ``static_lambda`` over that layer's K (and
    V) activations of one forward pass; the matrices are untouched."""
    _, _, model, params = lm
    from repro_torch.core.calibrate import static_lambda

    toks = torch.as_tensor(np.arange(64).reshape(2, 32) % 256)
    rots = model.init_rotations(torch.Generator().manual_seed(7))
    cal = serve.calibrate_lambdas(model, params, toks, rots)
    k_act, v_act = model.collect_kv(params, toks)
    for i, ((rk, rv), (ck, cv)) in enumerate(zip(rots, cal)):
        assert torch.equal(ck.matrix, rk.matrix)
        torch.testing.assert_close(
            ck.lam, static_lambda(rk, k_act[i].reshape(-1, 64)))
        torch.testing.assert_close(
            cv.lam, static_lambda(rv, v_act[i].reshape(-1, 64)))


def test_serve_int4_example_runs_on_cpu(capsys):
    from repro_torch.examples import serve_int4

    out = serve_int4.main(["--device", "cpu", "--steps", "1"])
    assert out["compression"] == pytest.approx(3.2)
    assert len(out["tokens"]) == serve_int4.BATCH
    assert all(len(t) == serve_int4.NEW for t in out["tokens"])
