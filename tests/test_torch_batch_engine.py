"""The slice as a whole: the port's ``BatchEngine`` (ragged slot cache and
paged pool) against ``repro.launch.batch_engine.BatchEngine`` on the same
requests, weights and rotations (bridged), and the invariants the
reference proves within itself, proven within the port: paged == dense,
copy-on-write prefix sharing, preemption with token stitching, every page
returned.  CPU, smol-d64, plain kernel versions.

Tolerances.  Across the two packages greedy tokens must agree, except
where the reference's top-2 logit gap at the first diverging step is
below LOGIT_TOL of its largest logit (the reference runs under ``jit``,
whose bf16 intermediates keep fp32 precision; the eager port rounds them,
so near-ties may flip -- the reference's own ragged-vs-single oracle
fails on such flips).  Within the port, paged and dense runs of rows that
map no shared page give equal tokens exactly: they differ only in
addressing (``kv_block`` equals the page size, so B1's and B2's plain
versions take the same tiles).  Rows that read pages another prompt wrote
(COW sharers) or that were recomputed after a preemption agree up to a
near-tie, judged on the port's own single-stream logits."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.batch_engine import BatchEngine as JBatchEngine  # noqa: E402
from repro.launch.batch_engine import Request as JRequest  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.paged import PagePool  # noqa: E402
from repro_torch.launch.batch_engine import BatchEngine, Request  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

LOGIT_TOL = 0.05
PS, S_MAX, CAP, CHUNK = 16, 64, 3, 4
PROMPTS, NEW = (9, 17, 40, 23), (8, 6, 10, 12)
KEY = jax.random.PRNGKey(7)
CASES = [("int4-srft", "gather", False), ("int4-srft", "kernel", True),
         ("bf16", "gather", True)]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The ops here are tiny: intra-op threads only add contention between
    test workers.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    jcfg = jget_config("smol-d64")
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = LM(get_config("smol-d64"), device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    return jm, jp, model, params, prompts


def _rots(jeng):
    d = jeng.cache["attn"].data
    if not hasattr(d, "rot_k"):
        return None
    return bridge.rotations({
        side: {f: np.asarray(getattr(getattr(d, f"rot_{side}"), f))
               for f in ("matrix", "lam", "signs")}
        for side in ("k", "v")})


def _requests(prompts, new=NEW, cls=Request):
    return [cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new))]


def _port(model, params, reqs, *, policy, backend, paged, rots=None, **kw):
    kw = dict(dict(capacity=CAP, s_max=S_MAX), **kw)
    eng = BatchEngine(model, params, policy=policy, backend=backend,
                      kv_block=PS, chunk=CHUNK, paged=paged, page_size=PS,
                      rots=rots, device="cpu", **kw)
    return eng, {c.rid: c for c in eng.run(list(reqs))}


def _agree_up_to_tie(ref, got, logits_at, what):
    """Equal tokens, or a first divergence at a near-tie of the reference
    logits (``logits_at(i)``: steps 0..i, (i+1, V))."""
    diff = np.nonzero(np.asarray(ref) != np.asarray(got))[0]
    assert len(ref) == len(got), what
    if not len(diff):
        return
    i = int(diff[0])
    lg = np.asarray(logits_at(i), np.float32)
    top2 = np.sort(lg[i])[-2:]
    tol = LOGIT_TOL * np.abs(lg).max()
    assert top2[1] - top2[0] < tol, (
        f"{what}: tokens diverge at step {i} with a top-2 gap of "
        f"{top2[1] - top2[0]} >= {tol}")


def _jax_logits(jm, jp, policy, backend, prompt, toks):
    """The reference's single-stream logits of one request, teacher-forced
    on ``toks``, under the engine's rotations (same key)."""

    def at(i):
        cache = jm.init_cache(1, S_MAX, policy=policy, key=KEY)
        logits, cache = jax.jit(jm.prefill)(
            jp, jnp.asarray(prompt[None], jnp.int32), cache)
        out = [np.asarray(logits[0, -1])]
        step = jax.jit(lambda p, t, c: jm.decode_step(
            p, t, c, backend=backend, kv_block=PS))
        for j in range(i):
            logits, cache = step(jp, jnp.asarray([[toks[j]]], jnp.int32),
                                 cache)
            out.append(np.asarray(logits[0, -1]))
        return np.stack(out)

    return at


def _port_logits(model, params, policy, backend, prompt, toks, rots):
    """The port's single-stream logits of one request, teacher-forced."""

    def at(i):
        cache = model.init_cache(1, S_MAX, policy=policy, rots=rots)
        logits, cache = model.prefill(
            params, torch.as_tensor(prompt[None]).long(), cache)
        out = [logits[0, -1]]
        for j in range(i):
            logits, cache = model.decode_step(
                params, torch.tensor([[int(toks[j])]]), cache,
                backend=backend, kv_block=PS)
            out.append(logits[0, -1])
        return torch.stack(out).numpy()

    return at


@pytest.mark.parametrize("policy,backend,paged", CASES)
def test_batch_engine_matches_reference(lm, policy, backend, paged):
    """Same requests through both packages' engines (capacity 3, four
    requests, so a slot is reused): per-request tokens agree up to a
    near-tie; prompt lengths and finish reasons are equal."""
    jm, jp, model, params, prompts = lm
    jeng = JBatchEngine(jm, jp, capacity=CAP, s_max=S_MAX, policy=policy,
                        backend=backend, kv_block=PS, chunk=CHUNK, key=KEY,
                        paged=paged, page_size=PS)
    want = {c.rid: c for c in jeng.run(_requests(prompts, cls=JRequest))}
    rots = _rots(jeng)
    eng, got = _port(model, params, _requests(prompts), policy=policy,
                     backend=backend, paged=paged, rots=rots)
    for i, p in enumerate(prompts):
        assert got[i].prompt_len == want[i].prompt_len == len(p)
        assert got[i].finish_reason == want[i].finish_reason == "length"
        _agree_up_to_tie(
            want[i].tokens, got[i].tokens,
            _jax_logits(jm, jp, policy, backend, p, want[i].tokens),
            f"{policy}/{backend}/{'paged' if paged else 'dense'} row {i}")
    if paged:
        assert eng.pool_stats()["pages_used"] == 0


@pytest.mark.parametrize("policy,backend", [(p, b) for p, b, _ in CASES])
def test_paged_equals_dense_within_the_port(lm, policy, backend):
    """Paged decode == dense ragged decode, token for token, for rows
    that share no page; every page is returned at the end."""
    _, _, model, params, prompts = lm
    reqs = _requests(prompts)
    _, dense = _port(model, params, reqs, policy=policy, backend=backend,
                     paged=False)
    eng, pag = _port(model, params, reqs, policy=policy, backend=backend,
                     paged=True)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(pag[i].tokens, dense[i].tokens)
    stats = eng.pool_stats()
    assert stats["pages_used"] == 0 and stats["peak_pages"] > 0


def test_shared_prefix_holds_one_physical_copy(lm):
    """Requests sharing a page-aligned 32-token prompt prefix map the same
    physical pages (refcount == number of sharers; pool usage below the
    no-sharing footprint) and decode like the dense engine, which shares
    nothing, up to a near-tie."""
    _, _, model, params, prompts = lm
    n_req = 3
    prefix = prompts[2][:32]
    reqs = [Request(rid=i, prompt=np.concatenate(
        [prefix, np.asarray([100 + i], np.int32)]), max_new_tokens=8)
        for i in range(n_req)]
    _, dense = _port(model, params, reqs, policy="int4-srft",
                     backend="kernel", paged=False)
    eng = BatchEngine(model, params, capacity=n_req, s_max=S_MAX,
                      policy="int4-srft", backend="kernel", kv_block=PS,
                      chunk=CHUNK, paged=True, page_size=PS, device="cpu")
    for r in reqs:
        eng.submit(r)
    got = {c.rid: c for c in eng.step()[1]}  # all admitted now
    rc = eng._refcount_host
    assert int((rc == n_req).sum()) == 32 // PS
    stats = eng.pool_stats()
    assert stats["shared_pages"] == 32 // PS
    assert stats["pages_used"] < n_req * eng._pages_needed(33, 8)
    while eng.has_work:
        got.update({c.rid: c for c in eng.step()[1]})
    for i, r in enumerate(reqs):
        _agree_up_to_tie(dense[i].tokens, got[i].tokens, _port_logits(
            model, params, "int4-srft", "kernel", r.prompt, dense[i].tokens,
            eng._rots), f"sharer {i}")
    assert eng.pool_stats()["pages_used"] == 0


def test_preemption_requeue_stitches_streams(lm):
    """An undersized pool (3 usable pages for two rows of 2 pages each)
    forces LRU recompute preemption; every stitched completion has its
    full length, the dense run's prompt length and finish reason, and its
    tokens agree with the dense run up to a near-tie."""
    _, _, model, params, prompts = lm
    reqs = _requests((prompts[0], prompts[3][:20]), new=(10, 8))
    _, dense = _port(model, params, reqs, policy="int4-srft",
                     backend="gather", paged=False, capacity=2, s_max=48)
    eng, pag = _port(model, params, reqs, policy="int4-srft",
                     backend="gather", paged=True, capacity=2, s_max=48,
                     n_pages=4)
    assert eng.n_preemptions > 0, "undersized pool must preempt"
    for i, r in enumerate(reqs):
        assert len(pag[i].tokens) == r.max_new_tokens
        assert pag[i].prompt_len == dense[i].prompt_len
        assert pag[i].finish_reason == dense[i].finish_reason
        _agree_up_to_tie(dense[i].tokens, pag[i].tokens, _port_logits(
            model, params, "int4-srft", "gather", r.prompt, dense[i].tokens,
            eng._rots), f"preempted request {i}")
    assert eng.pool_stats()["pages_used"] == 0


def _buffers(eng) -> dict:
    """Every tensor a captured decode step replays: the cache's leaves
    (lengths and page tables included), ``pos`` and the step's buffers.
    The host allocator (``PagePool``) is host state and is left out."""
    out = {"pos": eng.cache["pos"], "tok": eng.tok, "active": eng._active,
           "budget": eng._budget}

    def walk(name, x):
        if isinstance(x, torch.Tensor):
            out[name] = x
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(f"{name}[{i}]", v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, PagePool):
            for f in dataclasses.fields(x):
                walk(f"{name}.{f.name}", getattr(x, f.name))

    for i, st in enumerate(eng.cache["attn"]):
        walk(f"attn[{i}]", st.data)
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_decode_keeps_every_buffer_in_place(lm, policy, paged):
    """The counterpart of the reference's donation tests: across
    admissions, decode chunks, retirements and (paged) a preemption,
    every cache leaf, every length, ``pos`` and the step's buffers keep
    their storage, which is what lets a CUDA graph replay the step."""
    _, _, model, params, prompts = lm
    reqs = _requests((prompts[0], prompts[3][:20], prompts[1]),
                     new=(10, 8, 6))
    eng = BatchEngine(model, params, capacity=2, s_max=48, policy=policy,
                      backend="gather", kv_block=PS, chunk=CHUNK,
                      paged=paged, page_size=PS, n_pages=4 if paged else None,
                      device="cpu")
    before = {k: t.data_ptr() for k, t in _buffers(eng).items()}
    for r in reqs:
        eng.submit(r)
    n_chunks = 0
    while eng.has_work:
        eng.step()
        n_chunks += 1
        now = {k: t.data_ptr() for k, t in _buffers(eng).items()}
        assert now == before, [k for k in now if now[k] != before.get(k)]
    assert n_chunks > 2
    assert not paged or eng.n_preemptions > 0


def test_eos_cancel_and_temperature(lm):
    """An eos id stops a row early (finish reason "eos"); ``cancel_all``
    returns partial completions and every page; temperature sampling
    draws from the explicit generator (same seed, same streams)."""
    _, _, model, params, prompts = lm
    reqs = _requests(prompts)
    _, greedy = _port(model, params, reqs, policy="bf16", backend=None,
                      paged=True)
    eos = int(greedy[2].tokens[3])
    _, stopped = _port(model, params, reqs, policy="bf16", backend=None,
                       paged=True, eos_id=eos)
    first = list(greedy[2].tokens).index(eos)
    assert stopped[2].finish_reason == "eos"
    np.testing.assert_array_equal(stopped[2].tokens,
                                  greedy[2].tokens[:first + 1])

    eng = BatchEngine(model, params, capacity=2, s_max=S_MAX, policy="bf16",
                      chunk=2, paged=True, page_size=PS, device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng.n_active == 2 and eng.pending == 2 and eng.n_free_slots == 0
    done = eng.cancel_all()
    assert sorted(c.rid for c in done) == [0, 1, 2, 3]
    assert all(c.finish_reason == "cancelled" for c in done)
    assert eng.pool_stats()["pages_used"] == 0 and not eng.has_work

    from repro_torch.launch.engine import Sampler

    runs = []
    for _ in range(2):
        _, out = _port(model, params, reqs, policy="int4-srft",
                       backend="gather", paged=False,
                       sampler=Sampler(temperature=1.0),
                       generator=torch.Generator().manual_seed(5))
        runs.append(out)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(runs[0][i].tokens, runs[1][i].tokens)


def test_engine_validates_and_refuses_what_is_not_ported(lm):
    _, _, model, params, _ = lm
    with pytest.raises(ValueError, match="cannot hold"):
        BatchEngine(model, params, capacity=1, s_max=32, policy="bf16",
                    paged=True, page_size=8, n_pages=3, device="cpu")
    eng = BatchEngine(model, params, capacity=1, s_max=32, policy="bf16",
                      paged=True, page_size=8, n_pages=5, device="cpu")
    with pytest.raises(ValueError, match="exceeds s_max"):
        eng.submit(Request(rid=0, prompt=np.zeros(30, np.int32),
                           max_new_tokens=8))
    # the serving front-end's parts (A9) are ported: a recorder is adopted
    # (and handed to the host tier), an empty packed admission is a no-op
    from repro_torch.launch.server import TraceRecorder

    rec = TraceRecorder(capacity=8)
    traced = BatchEngine(model, params, capacity=1, s_max=32, device="cpu",
                         trace=rec)
    assert traced.trace is rec and not eng.trace.enabled
    eng.admit_packed([])
    assert not eng.has_work and eng.n_free_slots == 1
    # multi-device serving (A12a) is ported: a mesh shards the slot cache
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharded_cache import ShardedState

    sharded = BatchEngine(model, params, capacity=1, s_max=32, device="cpu",
                          mesh=make_mesh((1, 2), ("data", "model"),
                                         devices=["cpu"] * 2))
    assert isinstance(sharded.cache["attn"][0], ShardedState)
    # the host prefix tier (A6) is ported: it refuses what the reference
    # refuses
    with pytest.raises(ValueError, match="paged=True"):
        BatchEngine(model, params, capacity=1, s_max=32, device="cpu",
                    offload_bytes=1 << 20)
    with pytest.raises(ValueError, match="chunked admission"):
        BatchEngine(model, params, capacity=1, s_max=32, policy="bf16",
                    paged=True, page_size=8, device="cpu",
                    offload_bytes=1 << 20)
