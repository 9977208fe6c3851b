"""Multi-device serving in the port: the KV cache sharded by head over a
mesh's 'model' axis, params and scheduler state on the lead device
(``launch/mesh.py``, ``launch/sharded_cache.py``, ``Engine(mesh=)``,
``BatchEngine(mesh=)``).

A sharded engine must stream BIT-IDENTICAL tokens and finish reasons to
the unsharded one and leave the same bytes in every cache leaf (gathered
from its shards), for every policy, dense and paged, through COW forks,
preemption and spec rollback: the mirror of ``tests/test_sharded_serving.py``.
The mesh is a simulated ``(4, 2)`` mesh of ``cpu`` (the port's counterpart
of ``--xla_force_host_platform_device_count=8``): 'model' = 2 divides
smol-d64's 2 KV heads, 'data' = 4 only proves the rules ignore it; a
``(1, 8)`` mesh over an 8-KV-head variant holds one head a shard.  Every
comparison within the port is ``torch.equal``.  Across the packages, the
sharded ``Engine`` is held to the reference's unsharded per-step loop
within ``tests/test_torch_engine.py``'s LOGIT_TOL (0.05 of the largest
logit), for the reason that file states."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import paged as paged_mod  # noqa: E402
from repro_torch.core.cache_api import AttendBackend  # noqa: E402
from repro_torch.launch import partitioning as pt  # noqa: E402
from repro_torch.launch import sharded_cache as sc  # noqa: E402
from repro_torch.launch.batch_engine import (  # noqa: E402
    BatchEngine,
    Request,
    _leaves,
)
from repro_torch.launch.engine import Engine, mesh_allows_graph  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.server import SyncServer, cache_report_data  # noqa: E402
from repro_torch.launch.server.pipeline import drain_stream  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

S_MAX = 64
POLICIES = ("bf16", "int4-srft", "int8-per-token")
LOGIT_TOL = 0.05  # tests/test_torch_engine.py's, relative to the largest


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Tiny ops: intra-op threads only add contention between test
    workers.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def lm():
    model = LM(get_config("smol-d64"), device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def lm_mqa():
    model = LM(get_config("smol-d256"), device="cpu")  # Hkv = 1
    return model, model.init(torch.Generator().manual_seed(0))


def _prompts(lens, base=40, vocab=256):
    return [np.random.default_rng(base + i).integers(0, vocab, (n,))
            .astype(np.int32) for i, n in enumerate(lens)]


def _engine(model, params, *, mesh, **kw):
    kw.setdefault("capacity", 3)
    kw.setdefault("s_max", S_MAX)
    kw.setdefault("chunk", 4)
    kw.setdefault("kv_block", 16)
    return BatchEngine(model, params, device="cpu", mesh=mesh, **kw)


def _run(model, params, reqs, *, mesh, **kw):
    eng = _engine(model, params, mesh=mesh, **kw)
    out = {c.rid: (tuple(map(int, c.tokens)), c.finish_reason)
           for c in eng.run(list(reqs))}
    return out, eng


def _assert_stream_parity(ref, got, tag):
    assert sorted(got) == sorted(ref)
    for rid in ref:
        assert got[rid][0] == ref[rid][0], \
            f"{tag}: row {rid} diverged from the unsharded engine"
        assert got[rid][1] == ref[rid][1], f"{tag}: finish_reason {rid}"


def _assert_cache_parity(ref_states, got_states, tag):
    """Every leaf of every layer, the sharded one gathered from its
    shards, bit-equal to the unsharded one."""
    assert len(ref_states) == len(got_states)
    for i, (a, b) in enumerate(zip(ref_states, got_states)):
        la = pt.flatten_with_path(a)
        lb = pt.flatten_with_path(sc.gather_state(b))
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (pth, x), (_, y) in zip(la, lb):
            assert torch.equal(x, y), f"{tag}: layer {i} leaf {pth}"


def _requests(lens, news):
    return [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(lens), news))]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_stream_parity(lm, mesh, policy, paged):
    """The acceptance oracle: every policy x dense/paged, mixed prompt
    lengths, bit-identical streams and final cache bytes."""
    model, params = lm
    reqs = _requests((9, 17, 23), (10, 8, 6))
    kw = dict(policy=policy, backend="gather", paged=paged, page_size=16)
    ref, ref_eng = _run(model, params, reqs, mesh=None, **kw)
    got, eng = _run(model, params, reqs, mesh=mesh, **kw)
    assert all(isinstance(st, sc.ShardedState) for st in eng.cache["attn"])
    tag = f"{policy}/{'paged' if paged else 'dense'}"
    _assert_stream_parity(ref, got, tag)
    _assert_cache_parity(ref_eng.cache["attn"], eng.cache["attn"], tag)


def test_sharded_cow_fork_parity(lm, mesh):
    """COW prefix sharing on the sharded pool: sharers map the same
    physical pages (one refcount per sharer, every shard alike) and the
    forked rows decode as the unsharded dense engine does."""
    model, params = lm
    prefix = _prompts((32,), base=9)[0]
    reqs = [Request(rid=i, prompt=np.concatenate(
                [prefix, np.asarray([100 + i])]).astype(np.int32),
                max_new_tokens=8) for i in range(3)]
    ref, _ = _run(model, params, reqs, mesh=None, policy="int4-srft",
                  backend="gather", paged=False)
    eng = _engine(model, params, mesh=mesh, policy="int4-srft",
                  backend="gather", paged=True, page_size=16)
    for r in reqs:
        eng.submit(r)
    got = {}
    _, comp = eng.step()  # all admitted: sharing observable now
    rc = eng._refcount_host
    assert int((rc == 3).sum()) == 32 // 16, \
        "prefix pages must carry one reference per sharer (sharded pool)"
    for st in eng.cache["attn"]:
        for s in st.shards:
            assert torch.equal(s.data.kv.pool.refcount,
                               st.data.kv.pool.refcount)
            assert torch.equal(s.data.kv.page_table, st.data.kv.page_table)
    while True:
        for c in comp:
            got[c.rid] = (tuple(map(int, c.tokens)), c.finish_reason)
        if not (eng.pending or eng.n_active):
            break
        _, comp = eng.step()
    _assert_stream_parity(ref, got, "cow-fork")
    assert eng.pool_stats()["pages_used"] == 0


def test_sharded_preemption_resume_parity(lm, mesh):
    """An undersized sharded pool preempts and the recompute-resumed
    stream matches the never-preempting unsharded dense engine."""
    model, params = lm
    reqs = _requests((9, 20), (10, 8))
    ref, _ = _run(model, params, reqs, mesh=None, policy="int4-srft",
                  backend="gather", paged=False, capacity=2, s_max=48)
    got, eng = _run(model, params, reqs, mesh=mesh, policy="int4-srft",
                    backend="gather", paged=True, capacity=2, s_max=48,
                    page_size=16, n_pages=4)
    assert eng.n_preemptions > 0, "undersized pool must preempt"
    _assert_stream_parity(ref, got, "preempt-resume")
    assert eng.pool_stats()["pages_used"] == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sharded_spec_rollback_parity(lm, mesh, paged):
    """Speculative decoding on the sharded cache: k-wide verify appends
    and the rollback of rejected drafts leave streams equal to the plain
    unsharded run."""
    model, params = lm
    reqs = _requests((9, 17), (12, 10))
    kw = dict(policy="int4-srft", capacity=2, paged=paged, page_size=16)
    ref, _ = _run(model, params, reqs, mesh=None, **kw)
    got, eng = _run(model, params, reqs, mesh=mesh, spec_k=4, **kw)
    _assert_stream_parity(ref, got, f"spec4/{'paged' if paged else 'dense'}")
    assert 0 <= eng.n_accepted <= eng.n_drafted


@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_sharded_single_stream_engine_parity(lm, mesh, policy):
    """``Engine`` under a mesh: tokens and every stored cache byte equal
    the unsharded engine's (projections at full width on the lead)."""
    model, params = lm
    toks = torch.from_numpy(np.stack(_prompts((24, 24), base=3))).long()

    def run(mesh_):
        eng = Engine(model, backend="gather", mesh=mesh_)
        cache = model.init_cache(2, S_MAX, policy=policy,
                                 generator=torch.Generator().manual_seed(1))
        p = eng.shard_params(params)
        cache = eng.shard_cache(cache)
        out, cache = eng.generate(p, toks, cache, 12)
        return out, cache

    ref_out, ref_cache = run(None)
    got_out, got_cache = run(mesh)
    assert isinstance(got_cache["attn"][0], sc.ShardedState)
    assert torch.equal(got_out, ref_out)
    assert got_cache["pos"] == ref_cache["pos"]
    _assert_cache_parity(ref_cache["attn"], got_cache["attn"], "engine")


def test_mqa_degrades_to_replication_and_stays_exact(lm_mqa, mesh):
    """smol-d256 is MQA (Hkv = 1): heads cannot divide 'model', so every
    KV leaf gets ``P()``, the cache stays one unsharded state, and the
    engine matches the unsharded one."""
    model, params = lm_mqa
    cache = model.init_cache(2, 32, policy="int4-srft", ragged=True)
    specs = pt.serve_cache_specs(cache, mesh)
    assert all(s == pt.P() for _, s in pt.flatten_with_path(specs))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(_prompts((7, 11)))]
    kw = dict(policy="int4-srft", backend="gather", capacity=2, s_max=48)
    ref, _ = _run(model, params, reqs, mesh=None, **kw)
    got, eng = _run(model, params, reqs, mesh=mesh, **kw)
    assert not any(isinstance(st, sc.ShardedState)
                   for st in eng.cache["attn"])
    _assert_stream_parity(ref, got, "mqa-replicated")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kernel_backend_runs_per_shard_under_mesh(lm, mesh, paged):
    """A KERNEL read stays KERNEL on a mesh, with no warning (the
    reference falls back to BLOCKWISE: GSPMD cannot partition its Pallas
    call): each shard reads its heads through B1 / B2 (their plain
    versions on the CPU) with the unsplit read's split-K plan, and
    streams and cache bytes equal the unsharded KERNEL engine's."""
    import warnings

    model, params = lm
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = _engine(model, params, mesh=mesh, capacity=2, s_max=32,
                      policy="int4-srft", backend="kernel", paged=paged,
                      page_size=16)
        assert Engine(model, backend="kernel", mesh=mesh).backend \
            is AttendBackend.KERNEL
    assert eng.backend is AttendBackend.KERNEL
    reqs = _requests((9, 17), (6, 6))
    ref, ref_eng = _run(model, params, reqs, mesh=None, capacity=2,
                        s_max=32, policy="int4-srft", backend="kernel",
                        paged=paged, page_size=16)
    got = {c.rid: (tuple(map(int, c.tokens)), c.finish_reason)
           for c in eng.run(reqs)}
    _assert_stream_parity(ref, got, "kernel")
    _assert_cache_parity(ref_eng.cache["attn"], eng.cache["attn"], "kernel")


@pytest.fixture(scope="module")
def lm8():
    """smol-d64 with 8 KV heads (16 query heads of 32) and 2 layers: a
    'model' axis of 8 divides its heads, as internlm2-1.8b's on the card."""
    cfg = dataclasses.replace(get_config("smol-d64"), n_heads=16,
                              n_kv_heads=8, head_dim=32, n_layers=2)
    model = LM(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("policy,backend,paged", [
    ("int4-srft", "kernel", False), ("int4-srft", "kernel", True),
    ("bf16", "gather", True)], ids=["int4-dense", "int4-paged", "bf16-paged"])
def test_sharded_parity_at_m8(lm8, policy, backend, paged):
    """A (1, 8) mesh: one KV head a shard.  Streams and every cache leaf
    equal the unsharded engine's, through admission, decode-time ring
    flushes and a paged pool split eight ways."""
    model, params = lm8
    mesh8 = make_mesh((1, 8), ("data", "model"), devices=["cpu"] * 8)
    reqs = _requests((9, 17, 23), (10, 8, 6))
    kw = dict(policy=policy, backend=backend, paged=paged, page_size=16)
    ref, ref_eng = _run(model, params, reqs, mesh=None, **kw)
    got, eng = _run(model, params, reqs, mesh=mesh8, **kw)
    assert all(isinstance(st, sc.ShardedState) and st.m == 8
               for st in eng.cache["attn"])
    _assert_stream_parity(ref, got, f"m8 {policy}")
    _assert_cache_parity(ref_eng.cache["attn"], eng.cache["attn"],
                         f"m8 {policy}")


def test_nbytes_per_shard_vs_global(lm, mesh):
    """``nbytes()`` is global-logical (invariant under sharding);
    ``per_shard=True`` shrinks K/V by the 'model' factor while the
    replicated paging metadata counts in full; the serve report shows
    the per-shard figure only where it differs."""
    model, _ = lm
    msize = mesh.shape["model"]
    for paged in (False, True):
        cache = model.init_cache(
            2, S_MAX, policy="int4-srft", ragged=True,
            n_pages=9 if paged else None, page_size=16 if paged else None)
        st = cache["attn"][0]
        sharded = sc.shard_state(st, mesh)
        assert isinstance(sharded, sc.ShardedState)
        assert sharded.nbytes() == st.nbytes()
        assert sharded.nbytes(persistent_only=False) == \
            st.nbytes(persistent_only=False)
        assert sharded.nbytes(per_shard=True) == st.nbytes() // msize
        assert st.nbytes(per_shard=True) == st.nbytes()
        ratio = st.policy.compression_ratio(st)
        assert sharded.policy.compression_ratio(sharded) == ratio
        assert st.policy.compression_ratio(st, per_shard=True) == ratio
        tot = sharded.nbytes(persistent_only=False)
        per = sharded.nbytes(persistent_only=False, per_shard=True)
        if paged:
            assert per > tot // msize
            pd = sharded.data.kv
            assert paged_mod.meta_nbytes(pd, per_shard=True) == \
                paged_mod.meta_nbytes(pd)
            assert per - paged_mod.meta_nbytes(pd) == \
                (tot - paged_mod.meta_nbytes(pd)) // msize
        else:
            assert per == tot // msize
        rep = cache_report_data(st.policy, [sharded] * 2)
        assert rep["total_bytes"] == 2 * tot
        assert rep["per_shard_bytes"] == 2 * per
        assert "per_shard_bytes" not in cache_report_data(st.policy,
                                                          [st] * 2)


def test_shard_cache_refuses_split_k(lm, mesh):
    """``allow_split_k=True`` keeps the head split where the KV heads
    divide the axis (smol-d64's 2 heads over 'model' = 2: rung 1 of the
    serving rule), and on a (1, 3) mesh, where they do not, splits the
    dense leaves by position (rung 2, tests/test_torch_split_k.py holds
    its serving, tests/test_torch_split_k_spec.py its speculative
    path).  What split-K refuses is what it does not serve: chunked
    prefill, which the reference reaches only through BatchEngine.
    Identity without a mesh."""
    model, params = lm
    cache = model.init_cache(1, S_MAX, policy="int4-srft")
    heads = Engine(model, mesh=mesh).shard_cache(cache, allow_split_k=True)
    assert not heads["attn"][0].seq_split
    assert heads["attn"][0].span == S_MAX
    mesh3 = make_mesh((1, 3), ("data", "model"), devices=["cpu"] * 3)
    eng = Engine(model, mesh=mesh3)
    split = eng.shard_cache(model.init_cache(1, 66, policy="int4-srft"),
                            allow_split_k=True)
    st = split["attn"][0]
    assert st.seq_split and st.span == 22 and st.s_max == 66
    assert st.shards[0].data.kv.k_packed.shape[2] == 22
    assert eng.shard_cache(model.init_cache(1, 66, policy="int4-srft"))[
        "attn"][0].policy.name == "int4-srft"  # replicated: not split
    toks, _, _ = eng.generate_spec(params, torch.zeros((1, 4),
                                                       dtype=torch.long),
                                   split, 4, spec_k=2)
    assert toks.shape == (1, 4)
    _, h, _, d = st.data.kv.k_residual.shape
    with pytest.raises(NotImplementedError, match="only through BatchEngine"):
        st.policy.prefill_chunk(st, *(torch.zeros((1, h, 16, d))
                                      for _ in "kv"))
    assert Engine(model).shard_cache(cache, allow_split_k=True) is cache


def test_sharded_chunked_admission_parity(lm, mesh):
    """Chunked admission with token-level prefix reuse on a sharded
    paged pool: the donor pages are adopted shard by shard and the raw
    view gathered by head; streams and cache bytes equal the unsharded
    chunked engine's."""
    model, params = lm
    base = _prompts((40,), base=5)[0]
    reqs = [Request(rid=i, prompt=np.concatenate(
                [base, _prompts((n,), base=60 + i)[0]]), max_new_tokens=6)
            for i, n in enumerate((3, 9, 14))]
    kw = dict(policy="int4-srft", backend="gather", paged=True,
              page_size=16, prefill_chunk=16)
    ref, ref_eng = _run(model, params, reqs, mesh=None, **kw)
    got, eng = _run(model, params, reqs, mesh=mesh, **kw)
    assert eng.n_reused_tokens == ref_eng.n_reused_tokens > 0
    assert eng.n_prefill_chunks == ref_eng.n_prefill_chunks
    _assert_stream_parity(ref, got, "chunked")
    _assert_cache_parity(ref_eng.cache["attn"], eng.cache["attn"], "chunked")


def test_sharded_host_tier_spill_and_restore(lm, mesh):
    """The host prefix tier under a mesh: a retired prompt's pages are
    exported whole (the shards' heads concatenated), so the store holds
    the unsharded bytes; the same prompt again restores them shard by
    shard, and the stream equals the unsharded engine's."""
    model, params = lm
    prompt = _prompts((40,), base=11)[0]
    kw = dict(policy="int4-srft", backend="gather", paged=True,
              page_size=16, prefill_chunk=16, capacity=2,
              offload_bytes=1 << 24)
    outs, engs = [], []
    for m in (None, mesh):
        eng = _engine(model, params, mesh=m, **kw)
        out = []
        for rid in range(2):
            out += [(tuple(map(int, c.tokens)), c.finish_reason)
                    for c in eng.run([Request(rid=rid, prompt=prompt,
                                              max_new_tokens=5)])]
        outs.append(out)
        engs.append(eng)
    ref_eng, eng = engs
    assert outs[0] == outs[1]
    assert eng.n_spilled_pages == ref_eng.n_spilled_pages > 0
    assert eng.n_reuse_hits_host == ref_eng.n_reuse_hits_host == 1
    for key in list(ref_eng.prefix_store._entries):
        a, b = ref_eng.prefix_store.get(key), eng.prefix_store.get(key)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sync_server_over_a_sharded_engine(lm, mesh):
    """``SyncServer`` (packed admission through ``admit_packed``) over a
    sharded engine streams what it streams over the unsharded one."""
    model, params = lm
    prompts = _prompts((16, 16, 16, 24), base=80)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    out = []
    for m in (None, mesh):
        eng = _engine(model, params, mesh=m, policy="int4-srft",
                      backend="gather", paged=True, page_size=16)
        srv = SyncServer(eng, max_group=eng.capacity)
        streams = {r.rid: srv.submit(r) for r in reqs}
        srv.run_until_drained()
        out.append({rid: drain_stream(q, timeout=10.0)
                    for rid, q in streams.items()})
        srv.close()
        assert srv.bucketizer.n_packed > 0
    assert out[0] == out[1]


def test_sharded_engine_matches_reference(lm, mesh):
    """Across the packages: the sharded ``Engine``'s greedy stream against
    the reference's unsharded per-step loop on bridged weights and
    rotations, within LOGIT_TOL (teacher-forced logits; tokens equal up
    to a near-tie)."""
    jm = build_model(jget_config("smol-d64"))
    jp = jm.init(jax.random.PRNGKey(0))
    model = lm[0]
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    new = 12
    toks = np.stack(_prompts((23, 23), base=1))
    cache = jm.init_cache(2, S_MAX, policy="int4-srft",
                          key=jax.random.PRNGKey(7))
    logits, cache = jax.jit(jm.prefill)(jp, jnp.asarray(toks), cache)
    data = cache["attn"].data
    rots = bridge.rotations({
        side: {f: np.asarray(getattr(getattr(data, f"rot_{side}"), f))
               for f in ("matrix", "lam", "signs")} for side in ("k", "v")})
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    ref_t, ref_l = [np.asarray(tok)], [np.asarray(logits[:, -1])]
    step = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, backend="gather"))
    for _ in range(new - 1):
        logits, cache = step(jp, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        ref_t.append(np.asarray(tok))
        ref_l.append(np.asarray(logits[:, -1]))
    ref_t, ref_l = np.concatenate(ref_t, 1), np.stack(ref_l, 1)
    tol = LOGIT_TOL * np.abs(ref_l).max()

    eng = Engine(model, backend="gather", mesh=mesh)
    tcache = eng.shard_cache(model.init_cache(2, S_MAX, policy="int4-srft",
                                              rots=rots))
    got_t, got_l, _ = eng.generate(eng.shard_params(params),
                                   torch.from_numpy(toks).long(), tcache,
                                   new, return_logits=True)
    got_t, got_l = got_t.numpy(), got_l.numpy()
    diverged = np.argwhere(got_t != ref_t)
    if len(diverged):
        b, i = diverged[np.argmin(diverged[:, 1])]
        top2 = np.sort(ref_l[b, i])[-2:]
        assert top2[1] - top2[0] < tol, f"diverged at step {i}, row {b}"
    n_same = diverged[:, 1].min() + 1 if len(diverged) else new
    assert np.abs(got_l[:, :n_same] - ref_l[:, :n_same]).max() <= tol


def test_mesh_construction_and_placement():
    """Meshes: a repeated device list is a simulated mesh; the default
    needs visible cards; ``shard_tree`` then ``gather_tree`` gives the
    tree back bit for bit on 2-d and 3-d meshes, each piece the slice its
    coordinate names."""
    m = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=["cpu"] * 8)
    assert m.shape == {"pod": 2, "data": 2, "model": 2} and m.size == 8
    assert m.lead == torch.device("cpu") and len(m.cards) == 1
    assert m.devices_along("model") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="0 CUDA card"):
            make_mesh((1, 2), ("data", "model"))
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(8, 4, generator=g),
            "blocks": [{"b": torch.arange(12.0).reshape(2, 6)}],
            "n": 3}
    for mesh_ in (m, make_mesh((4, 2), ("data", "model"),
                               devices=["cpu"] * 8)):
        specs = {"w": pt.P(("pod", "data") if "pod" in mesh_.axis_names
                           else "data", "model"),
                 "blocks": [{"b": pt.P(None, "model")}]}
        placed = pt.shard_tree(tree, specs, mesh_)
        w = placed["w"]
        assert isinstance(w, pt.Sharded) and w.pieces.shape == \
            mesh_.devices.shape
        n_rows = 8 // (mesh_.size // mesh_.shape["model"])
        assert tuple(w.pieces.flat[-1].shape) == (n_rows, 2)
        assert torch.equal(w.pieces.flat[-1], tree["w"][-n_rows:, 2:])
        back = pt.gather_tree(placed)
        assert torch.equal(back["w"], tree["w"])
        assert torch.equal(back["blocks"][0]["b"], tree["blocks"][0]["b"])
        assert back["n"] == 3


def test_mesh_over_several_cards_steps_eagerly():
    """A mesh whose shards lie on more than one card takes the eager
    loop; asking for the graph there raises."""
    two = make_mesh((1, 2), ("data", "model"), devices=["cpu", "meta"])
    assert mesh_allows_graph(two, None) is False
    with pytest.raises(ValueError, match="graph=True"):
        mesh_allows_graph(two, True)
    one = make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    assert mesh_allows_graph(one, True) and mesh_allows_graph(None, None)


def test_batch_slice_of_a_sharded_staging_cache(lm, mesh):
    """``_leaves`` walks every shard of a sharded state, and packed
    admission's row slicing keeps the shards apart."""
    model, params = lm
    eng = _engine(model, params, mesh=mesh, policy="int4-srft",
                  backend="gather")
    staged = eng._shard_cache_tree(model.init_cache(
        2, S_MAX, policy="int4-srft", ragged=True))
    st = staged["attn"][0]
    n_plain = len(list(_leaves(model.init_cache(
        1, 16, policy="int4-srft", ragged=True)["attn"][0])))
    assert len(list(_leaves(st))) == 2 * n_plain
    row = eng._slice_row(staged, 1)["attn"][0]
    assert isinstance(row, sc.ShardedState) and row.m == 2
    for j, s in enumerate(row.shards):
        assert s.data.kv.k_packed.shape[:2] == (1, 1)
        assert torch.equal(s.data.kv.k_packed[0],
                           st.shards[j].data.kv.k_packed[1])


def test_serve_cli_mesh(tmp_path, capsys, monkeypatch):
    """``--mesh 1`` (and ``auto`` on a one-device host) means no mesh;
    ``--mesh 2`` there exits with the message; a mesh the CLI is handed
    (a simulated one, as ``_build_mesh`` would build on two cards) serves
    the closed loop sharded, and the report and ``/healthz`` carry one
    device's bytes."""
    import json

    from repro_torch.launch import serve
    from repro_torch.launch.server.http import _shard_bytes

    dev = torch.device("cpu")
    assert serve._build_mesh("1", dev) is None
    assert serve._build_mesh("auto", dev) is None
    with pytest.raises(SystemExit, match="than the 1 visible"):
        serve._build_mesh("2", dev)
    argv = ["--arch", "smol-d64", "--device", "cpu", "--paged",
            "--policy", "int4-srft", "--max-batch", "2", "--requests", "3",
            "--prompt-len", "24", "--new-tokens", "4"]
    plain, sharded = tmp_path / "plain.json", tmp_path / "sharded.json"
    serve.main(argv + ["--mesh", "1", "--stats-json", str(plain)])
    out = capsys.readouterr().out
    assert out.count("[done]") == 3 and "mesh-sharded" not in out
    monkeypatch.setattr(serve, "_build_mesh", lambda arg, d: make_mesh(
        (1, 2), ("data", "model"), devices=["cpu"] * 2))
    serve.main(argv + ["--mesh", "2", "--stats-json", str(sharded)])
    out = capsys.readouterr().out
    assert "mesh-sharded x2" in out and "per shard" in out
    a, b = (json.loads(p.read_text()) for p in (plain, sharded))
    assert "per_shard_bytes" not in a["cache"]
    assert b["cache"]["total_bytes"] == a["cache"]["total_bytes"]
    assert b["cache"]["per_shard_bytes"] < b["cache"]["total_bytes"]
    model = LM(get_config("smol-d64"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    mesh_ = make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    health = _shard_bytes(_engine(model, params, mesh=mesh_,
                                  policy="int4-srft", paged=True))
    assert health["mesh_model_shards"] == 2
    assert health["per_shard_bytes"] < health["cache_bytes"]
    assert _shard_bytes(_engine(model, params, mesh=None)) == {}


def test_serve_cli_single_stream_family_under_a_mesh(capsys, monkeypatch):
    """A recurrent family is served single-stream through ``Engine``; its
    attention states shard like any other (zamba2's shared block)."""
    from repro_torch.launch import serve

    monkeypatch.setattr(serve, "_build_mesh", lambda arg, d: make_mesh(
        (1, 2), ("data", "model"), devices=["cpu"] * 2))
    serve.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
                "--mesh", "2", "--max-batch", "1", "--requests", "1",
                "--prompt-len", "16", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "single-stream family" in out and "per shard" in out
