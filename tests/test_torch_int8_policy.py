"""The ``int8-per-token`` policy (ROADMAP A7) against the reference's
(``repro/core/cache_api.py:1107-1371``) on bridged inputs, then the
engines under it against the reference's engines, and the invariants the
port proves for the other policies proven for this one: speculative ==
plain decoding, and (on a card) the captured step == the eager loop.
The quickstart that serves under all three policies runs at two training
steps.  CPU, plain versions; inputs from numpy seeds, params carried
across by ``repro_torch.bridge``.

Tolerances.  Codes, scales, lengths and page tables are the same bytes in
both packages (the same true division and round-half-even on the same
fp32 values).  Attention reads are within READ_ATOL of the reference's
(fp32 sums in another order; outputs are O(1)).  Engine streams agree
with the reference's up to a near-tie (``tests/test_torch_engine.py``'s
rule: the reference keeps bf16 intermediates in fp32 under ``jit``).
Within the port, spec == plain bit for bit; graph == eager as
``tests/test_torch_graph.py`` states."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.cache_api import get_policy as jget_policy  # noqa: E402
from repro.launch.batch_engine import BatchEngine as JBatchEngine  # noqa: E402
from repro.launch.batch_engine import Request as JRequest  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import paged  # noqa: E402
from repro_torch.core.cache_api import (  # noqa: E402
    AttendBackend,
    Int8PerTokenPolicy,
    get_policy,
)
from repro_torch.launch.batch_engine import BatchEngine, Request  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

NAME = "int8-per-token"
LOGIT_TOL = 0.05
READ_ATOL = 2e-5
B, H, HQ, D, S_MAX, PS = 3, 2, 4, 64, 64, 16
N_PAGES = 2 * B * (S_MAX // PS) + 1
KEY = jax.random.PRNGKey(7)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _tj(x):
    """(port bf16 tensor, reference bf16 array) of the same values."""
    return torch.from_numpy(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)


def _fields(state):
    """Leaves by name: codes and scales (or pools), length."""
    d = state.data
    if isinstance(d, paged.PagedData):
        return {"pool0": d.pools[0], "pool1": d.pools[1],
                "pool2": d.pools[2], "pool3": d.pools[3],
                "length": d.length, "table": d.page_table}
    return {"k_codes": d.k_codes, "k_scales": d.k_scales,
            "v_codes": d.v_codes, "v_scales": d.v_scales,
            "length": d.length}


def _jfields(state):
    d = state.data
    if hasattr(d, "pools"):
        return {"pool0": d.pools[0], "pool1": d.pools[1],
                "pool2": d.pools[2], "pool3": d.pools[3],
                "length": d.length, "table": d.page_table}
    return d._asdict()


def _assert_same(state, jstate, what, skip_null=False):
    got, want = _fields(state), _jfields(jstate)
    for name, t in got.items():
        g = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        w = np.asarray(want[name])
        if skip_null and name.startswith("pool"):
            g, w = g[1:], w[1:]  # the null page takes masked writes
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


class _Pair:
    """The same int8 cache in both packages, driven by the same inputs."""

    def __init__(self, layout):
        self.pol, self.jpol = get_policy(NAME), jget_policy(NAME)
        self.layout = layout
        if layout == "paged":
            self.ts = self.pol.init_paged(B, H, S_MAX, D, n_pages=N_PAGES,
                                          page_size=PS, device="cpu")
            self.js = self.jpol.init_paged(B, H, S_MAX, D, n_pages=N_PAGES,
                                           page_size=PS)
        else:
            ragged = layout == "ragged"
            self.ts = self.pol.init_state(B, H, S_MAX, D, device="cpu",
                                          ragged=ragged)
            self.js = self.jpol.init_state(B, H, S_MAX, D, ragged=ragged)

    def admit(self, rng, lens):
        """Prefill a batch-1 row per slot and insert it (dense copy or
        paged COW insert with fresh pages)."""
        for slot, n in enumerate(lens):
            k, v = _bf16(rng, 1, H, n, D), _bf16(rng, 1, H, n, D)
            (tk, jk), (tv, jv) = _tj(k), _tj(v)
            trow = self.pol.prefill(self.pol.init_state(
                1, H, S_MAX, D, device="cpu", ragged=True), tk, tv)
            jrow = self.jpol.prefill(self.jpol.init_state(
                1, H, S_MAX, D, ragged=True), jk, jv)
            _assert_same(trow, jrow, f"prefill of row {slot}")
            if self.layout == "paged":
                n_new = -(-(n + 20) // PS)
                mp = S_MAX // PS
                self.pol.insert_row_paged(self.ts, trow, slot, [], 0, n_new)
                self.js = self.jpol.insert_row_paged(
                    self.js, jrow, slot, jnp.zeros((mp,), jnp.int32),
                    jnp.int32(0), jnp.int32(n_new))
            else:
                self.pol.insert_row(self.ts, trow, slot)
                self.js = self.jpol.insert_row(self.js, jrow, slot)

    def update(self, rng, active=None):
        k, v = _bf16(rng, B, H, 1, D), _bf16(rng, B, H, 1, D)
        (tk, jk), (tv, jv) = _tj(k), _tj(v)
        ta = None if active is None else torch.as_tensor(active)
        ja = None if active is None else jnp.asarray(active)
        self.pol.update(self.ts, tk, tv, active=ta)
        self.js = self.jpol.update(self.js, jk, jv, active=ja)

    def chunk(self, rng, C):
        k, v = _bf16(rng, B, H, C, D), _bf16(rng, B, H, C, D)
        (tk, jk), (tv, jv) = _tj(k), _tj(v)
        self.pol.prefill_chunk(self.ts, tk, tv)
        self.js = self.jpol.prefill_chunk(self.js, jk, jv)

    def check(self, what):
        _assert_same(self.ts, self.js, what,
                     skip_null=self.layout == "paged")


def test_plain_prefill_and_scalar_updates_equal_reference():
    rng = np.random.default_rng(0)
    pol, jpol = get_policy(NAME), jget_policy(NAME)
    k, v = _bf16(rng, B, H, 23, D), _bf16(rng, B, H, 23, D)
    (tk, jk), (tv, jv) = _tj(k), _tj(v)
    ts = pol.prefill(pol.init_state(B, H, S_MAX, D, device="cpu"), tk, tv)
    js = jpol.prefill(jpol.init_state(B, H, S_MAX, D), jk, jv)
    assert ts.length == 23
    for _ in range(3):
        k, v = _bf16(rng, B, H, 1, D), _bf16(rng, B, H, 1, D)
        (tk, jk), (tv, jv) = _tj(k), _tj(v)
        pol.update(ts, tk, tv)
        js = jpol.update(js, jk, jv)
    assert ts.length == int(js.data.length) == 26
    got, want = _fields(ts), _jfields(js)
    for name in ("k_codes", "k_scales", "v_codes", "v_scales"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), name)
    assert pol.nbytes(ts) == jpol.nbytes(js)
    assert pol.compression_ratio(ts) == pytest.approx(
        jpol.compression_ratio(js), rel=1e-12)
    with pytest.raises(ValueError, match="cache full"):
        pol.update(pol.prefill(pol.init_state(1, H, 8, D, device="cpu"),
                               tk[:1].expand(1, H, 8, D),
                               tv[:1].expand(1, H, 8, D)), tk[:1], tv[:1])


@pytest.mark.parametrize("layout", ["ragged", "paged"])
def test_updates_and_chunks_equal_reference(layout):
    """Ragged or paged: admitted rows of 9 / 20 / 33 tokens, updates with
    and without an active mask, a chunk of 5 and one of 16: every byte,
    length and page table equal (the null page aside)."""
    rng = np.random.default_rng(1)
    pair = _Pair(layout)
    pair.admit(rng, (9, 20, 33))
    pair.check("after admission")
    pair.update(rng)
    pair.update(rng, active=np.array([True, False, True]))
    pair.check("after updates")
    pair.chunk(rng, 5)
    pair.chunk(rng, 16)
    pair.check("after chunks")
    assert pair.pol.nbytes(pair.ts) == pair.jpol.nbytes(pair.js)
    assert pair.pol.nbytes(pair.ts, persistent_only=False) == \
        pair.jpol.nbytes(pair.js, persistent_only=False)
    assert pair.pol.compression_ratio(pair.ts) == pytest.approx(
        pair.jpol.compression_ratio(pair.js), rel=1e-12)


@pytest.mark.parametrize("layout", ["plain", "ragged", "paged"])
def test_gather_read_verify_and_truncate_equal_reference(layout):
    """GATHER's read; then k = 3 appends, the verify read against the
    entry snapshot, and ``truncate_rows`` back to entry + 1."""
    rng = np.random.default_rng(2)
    pol, jpol = get_policy(NAME), jget_policy(NAME)
    if layout == "plain":
        k, v = _bf16(rng, B, H, 23, D), _bf16(rng, B, H, 23, D)
        (tk, jk), (tv, jv) = _tj(k), _tj(v)
        ts = pol.prefill(pol.init_state(B, H, S_MAX, D, device="cpu"),
                         tk, tv)
        js = jpol.prefill(jpol.init_state(B, H, S_MAX, D), jk, jv)
    else:
        pair = _Pair(layout)
        pair.admit(rng, (9, 20, 33))
        ts, js = pair.ts, pair.js
    q = _bf16(rng, B, HQ, 1, D)  # fp32 queries: outputs not rounded
    tq, jq = torch.from_numpy(q), jnp.asarray(q)
    got = pol.attend(tq, ts, scale=D ** -0.5).float().numpy()
    want = np.asarray(jpol.attend(jq, js, scale=D ** -0.5), np.float32)
    np.testing.assert_allclose(got, want, atol=READ_ATOL)

    snap = pol.snapshot_rows(ts)
    jsnap = jpol.snapshot_rows(js)
    for _ in range(3):
        k, v = _bf16(rng, B, H, 1, D), _bf16(rng, B, H, 1, D)
        (tk, jk), (tv, jv) = _tj(k), _tj(v)
        pol.update(ts, tk, tv)
        js = jpol.update(js, jk, jv)
    qv = _bf16(rng, B, HQ, 3, D)
    tq, jq = torch.from_numpy(qv), jnp.asarray(qv)
    for backend in ("gather", "kernel"):
        got = pol.verify_attend(tq, ts, snap, scale=D ** -0.5,
                                backend=backend).float().numpy()
        want = np.asarray(jpol.verify_attend(jq, js, jsnap, scale=D ** -0.5,
                                             backend=backend), np.float32)
        np.testing.assert_allclose(got, want, atol=READ_ATOL)
    new_len = snap + 1
    pol.truncate_rows(ts, new_len, snap)
    js = jpol.truncate_rows(
        js, jnp.asarray(new_len.numpy() if layout != "plain" else new_len),
        jsnap)
    np.testing.assert_array_equal(np.asarray(ts.data.length),
                                  np.asarray(js.data.length))
    assert pol.rollback_leaves(ts) == (ts.data.length,)


def test_blockwise_and_kernel_reads_raise():
    pol = get_policy(NAME)
    st = pol.init_state(1, H, 32, D, device="cpu", ragged=True)
    q = torch.zeros((1, HQ, 1, D), dtype=torch.bfloat16)
    for backend in ("blockwise", "kernel", AttendBackend.KERNEL):
        with pytest.raises(NotImplementedError, match="GATHER"):
            pol.attend(q, st, backend=backend)
    assert isinstance(get_policy(NAME, group=32, window=16),
                      Int8PerTokenPolicy)
    assert pol.with_rotations(st, None, None) is st


def test_snapshot_copies_into_caller_buffers():
    """``snapshot_rows(into=)`` writes the lengths into the caller's
    buffer (the fixed address a captured pass replays) and returns it."""
    pol = get_policy(NAME)
    st = pol.init_state(2, H, 32, D, device="cpu", ragged=True)
    st.data.length.copy_(torch.tensor([3, 7], dtype=torch.int32))
    buf = torch.zeros(2, dtype=torch.int32)
    out = pol.snapshot_rows(st, into=buf)
    assert out is buf and buf.tolist() == [3, 7]
    fresh = pol.snapshot_rows(st)
    assert fresh.data_ptr() != st.data.length.data_ptr()


def test_entry_points_refuse_a_silent_cpu_path(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pol = get_policy(NAME)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pol.init_state(1, 1, 32, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pol.init_paged(1, 1, 32, 64, n_pages=3, page_size=16)


# ------------------------------------------------------------- engines

@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(jget_config("smol-d64"), n_layers=2)
    cfg = dataclasses.replace(get_config("smol-d64"), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    return jm, jp, model, params


def _near_tie(ref_t, got_t, logits, tol, what):
    """Tokens equal up to a first divergence at a near-tie of ``logits``
    (the teacher-forced logits of ``ref_t``)."""
    ref_t, got_t = np.asarray(ref_t), np.asarray(got_t)
    assert ref_t.shape == got_t.shape, what
    diff = np.nonzero(ref_t != got_t)[0]
    if not len(diff):
        return
    i = int(diff[0])
    top2 = np.sort(np.asarray(logits[i], np.float32))[-2:]
    assert top2[1] - top2[0] < tol, f"{what}: diverge at step {i}"


def _forced(model, params, prompt, toks):
    """The port's logits of each of ``toks``, teacher-forced, alone."""
    cache = model.init_cache(1, S_MAX, policy=NAME)
    lg, cache = model.prefill(params, torch.as_tensor(
        np.asarray(prompt, np.int64))[None], cache)
    out = [lg[0, -1]]
    for t in toks[:-1]:
        lg, cache = model.decode_step(params, torch.tensor([[int(t)]]),
                                      cache)
        out.append(lg[0, -1])
    return torch.stack(out).numpy()


def test_engine_stream_matches_reference(lm):
    """``Engine.generate`` on a plain and a ragged cache against the
    reference's per-step loop: teacher-forced logits within LOGIT_TOL,
    greedy tokens up to a near-tie; the two caches' streams are equal."""
    jm, jp, model, params = lm
    toks = np.random.default_rng(3).integers(0, 256, (2, 23)).astype(
        np.int32)
    new = 20
    cache = jm.init_cache(2, S_MAX, policy=NAME, key=KEY)
    logits, cache = jax.jit(jm.prefill)(jp, jnp.asarray(toks), cache)
    step = jax.jit(jm.decode_step)
    ref_t, ref_l = [], []
    for _ in range(new):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        ref_t.append(np.asarray(tok))
        ref_l.append(np.asarray(logits[:, -1]))
        logits, cache = step(jp, tok, cache)
    ref_t, ref_l = np.concatenate(ref_t, 1), np.stack(ref_l, 1)
    tol = LOGIT_TOL * np.abs(ref_l).max()
    prompt = torch.from_numpy(toks).long()

    tcache = model.init_cache(2, S_MAX, policy=NAME)
    lg, tcache = model.prefill(params, prompt, tcache)
    forced = [lg[:, -1]]
    for i in range(new - 1):
        lg, tcache = model.decode_step(
            params, torch.from_numpy(ref_t[:, i:i + 1]).long(), tcache)
        forced.append(lg[:, -1])
    err = np.abs(torch.stack(forced, 1).numpy() - ref_l).max()
    assert err <= tol, f"teacher-forced logits off by {err} > {tol}"

    eng = Engine(model)
    outs = {}
    for ragged in (False, True):
        c = model.init_cache(2 if not ragged else 1, S_MAX, policy=NAME,
                             ragged=ragged)
        p = prompt if not ragged else prompt[:1]
        outs[ragged] = eng.generate(params, p, c, new)[0].numpy()
    assert np.array_equal(outs[True][0], outs[False][0])
    for b in range(2):
        _near_tie(ref_t[b], outs[False][b], ref_l[b], tol, f"row {b}")


def _batch_reqs(cls):
    rng = np.random.default_rng(4)
    lens, news = (9, 37, 9, 37), (8, 6, 10, 7)  # two shapes to compile
    return [cls(rid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("paged_,chunk", [(False, None), (True, None),
                                          (False, PS), (True, PS)],
                         ids=["dense", "paged", "dense-chunked",
                              "paged-chunked"])
def test_batch_engine_streams_match_reference(lm, paged_, chunk):
    """``BatchEngine`` (capacity 3, four requests: slot reuse; paged,
    monolithic and chunked) against the reference's engine on the same
    requests: every stream up to a near-tie, judged on the port's own
    teacher-forced logits; every page returned."""
    jm, jp, model, params = lm
    kw = dict(capacity=3, s_max=S_MAX, policy=NAME, chunk=4, paged=paged_,
              page_size=PS, prefill_chunk=chunk)
    jeng = JBatchEngine(jm, jp, key=KEY, **kw)
    want = {c.rid: c for c in jeng.run(_batch_reqs(JRequest))}
    eng = BatchEngine(model, params, device="cpu", **kw)
    got = {c.rid: c for c in eng.run(_batch_reqs(Request))}
    for r in _batch_reqs(Request):
        a, b = want[r.rid].tokens, got[r.rid].tokens
        assert len(b) == r.max_new_tokens
        assert got[r.rid].finish_reason == want[r.rid].finish_reason
        lg = _forced(model, params, r.prompt, a)
        _near_tie(a, b, lg, LOGIT_TOL * np.abs(lg).max(),
                  f"request {r.rid}")
    if paged_:
        assert eng.pool_stats()["pages_used"] == 0
    if chunk:
        assert eng.n_prefill_chunks == jeng.n_prefill_chunks


@pytest.mark.parametrize("ragged", [False, True], ids=["plain", "ragged"])
def test_engine_spec_equals_plain(lm, ragged):
    _, _, model, params = lm
    base = np.random.default_rng(1).integers(0, 256, (1, 6))
    prompt = torch.from_numpy(np.tile(base, (1, 5))[:, :23]).long()
    eng = Engine(model)
    ref, _ = eng.generate(params, prompt, model.init_cache(
        1, S_MAX, policy=NAME, ragged=ragged), 13)
    cache = model.init_cache(1, S_MAX, policy=NAME, ragged=ragged)
    out, cache, stats = eng.generate_spec(params, prompt, cache, 13,
                                          spec_k=4)
    assert torch.equal(out, ref)
    assert 0 <= stats["accepted"] <= stats["drafted"]


@pytest.mark.parametrize("paged_", [False, True], ids=["dense", "paged"])
def test_batch_spec_equals_plain(lm, paged_):
    _, _, model, params = lm
    out = []
    for spec_k in (None, 4):
        eng = BatchEngine(model, params, capacity=3, s_max=S_MAX,
                          policy=NAME, chunk=4, paged=paged_, page_size=PS,
                          spec_k=spec_k, device="cpu")
        out.append({c.rid: (c.tokens.tolist(), c.finish_reason)
                    for c in eng.run(_batch_reqs(Request))})
        if paged_:
            assert eng.pool_stats()["pages_used"] == 0
    assert out[0] == out[1]


def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart

    rec = quickstart.main(["--device", "cpu", "--steps", "2"])
    assert len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    assert rec["kernel"]["b3_code_agreement"] == 1.0
    ratios = {k: v["compression"] for k, v in rec["policies"].items()}
    assert ratios["bf16"] == 1.0
    assert ratios["int4-srft"] == pytest.approx(3.2)
    assert ratios[NAME] == pytest.approx(256 / 136)  # 2*2*64 / (2*(64+4))
    assert "quickstart done." in capsys.readouterr().out


# ---------------------------------------------------------------- card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from repro_torch.configs import reduced

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LM(reduced(get_config("internlm2-1.8b")), device="cuda")
    return model, model.init(model.generator(0))


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_the_card(card):
    """``Engine`` and paged ``BatchEngine`` under int8: the captured step's
    tokens equal the eager loop's, a replay makes no host sync, and a
    verify pass's snapshot lands in the caller's buffers."""
    model, params = card
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, 37),
                           generator=g).cuda()
    toks = {}
    for graph in (False, True):
        cache = model.init_cache(1, 128, policy=NAME, ragged=True)
        toks[graph], cache = Engine(model, graph=graph).generate(
            params, prompt, cache, 24)
    assert torch.equal(toks[True], toks[False])
    eng = Engine(model)
    tok = toks[True][:, -1:]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.decode(params, tok, cache, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    st = cache["attn"][0]
    buf = torch.zeros_like(st.data.length)
    assert st.policy.snapshot_rows(st, into=buf) is buf
    assert torch.equal(buf, st.data.length)
    reqs = [Request(rid=i, prompt=torch.randint(
        0, model.cfg.vocab_size, (n,), generator=g).numpy(),
        max_new_tokens=12) for i, n in enumerate((9, 40, 23))]
    out = []
    for graph in (False, True):
        beng = BatchEngine(model, params, capacity=2, s_max=128,
                           policy=NAME, paged=True, page_size=PS,
                           graph=graph)
        out.append({c.rid: c.tokens.tolist() for c in beng.run(reqs)})
        assert beng.pool_stats()["pages_used"] == 0
    assert out[0] == out[1]
