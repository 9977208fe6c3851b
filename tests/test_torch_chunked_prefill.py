"""Chunked prefill with token-level prefix reuse (ROADMAP A4): the port's
``prefill_chunk`` writes, the paged chunk and page reads, ``raw_kv_view``,
``LM.prefill_chunk`` and ``BatchEngine(prefill_chunk=...)`` against the
reference (``repro/core/kvcache.py:333, :394``, ``repro/core/paged.py:254,
:341, :364, :507``, ``repro/core/cache_api.py:617-651, :867-918``,
``repro/models/lm.py:560``, ``repro/launch/batch_engine.py``), and the
invariants the reference proves within itself (``tests/
test_chunked_prefill.py``) proven within the port.  CPU, smol-d64 cut to
2 layers, plain kernel versions; inputs from numpy seeds, params and
rotations carried across by ``repro_torch.bridge``.

Tolerances.  Within the port, chunked and monolithic prefill are equal
byte for byte (policy level) and token for token (engine level):
quantization is per token and the chunk's queries attend the raw bytes.
The engine-level equality also needs each product to round a row the
same at the chunk's row count as at the prompt's, which PyTorch's CPU
matmul does not promise at every shape: it is shown at these shapes,
where it holds, as the reference's test shows it at its own.
Across packages, page reads and chunk writes of the same bytes are equal;
``raw_kv_view`` is bit-equal for bf16 and within one bf16 ulp for int4
(the port's B4 multiplies by the folded inverse, the reference divides by
lambda first, so the fp32 sums run in another order: the share of
elements that flip is printed); ``LM.prefill_chunk`` logits are within
LOGIT_TOL of the reference's largest logit and engine streams agree up to
a near-tie, as ``tests/test_torch_engine.py`` and
``tests/test_torch_batch_engine.py`` state (the reference keeps bf16
intermediates in fp32 under ``jit``)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import cache_api as jcache_api  # noqa: E402
from repro.core import paged as jpaged  # noqa: E402
from repro.launch.batch_engine import BatchEngine as JBatchEngine  # noqa: E402
from repro.launch.batch_engine import Request as JRequest  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import paged  # noqa: E402
from repro_torch.core.cache_api import get_policy  # noqa: E402
from repro_torch.core.transforms import Rotation  # noqa: E402
from repro_torch.launch.batch_engine import BatchEngine, Request  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

LOGIT_TOL = 0.05
PS, S_MAX, W = 16, 64, 16
KEY = jax.random.PRNGKey(7)
H, D = 2, 64


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x):
    """Comparable bytes of a tensor or array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _port_leaf(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _kv(seed, B, S):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(
        np.float32)).bfloat16() for _ in "kv"]


def _leaves(state):
    d = state.data
    kv = getattr(d, "kv", d)
    return {f.name: getattr(kv, f.name) for f in dataclasses.fields(kv)
            if isinstance(getattr(kv, f.name), torch.Tensor)}


# ----------------------------------------------------------- policy layer

@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_policy_chunks_equal_monolithic_prefill_dense(policy):
    """Chunks of 32, 32 and 6 tokens (the last leaves a tail in the ring)
    give every leaf of one monolithic prefill, byte for byte."""
    pol = get_policy(policy)
    B, S = 2, 70
    k, v = _kv(1, B, S)
    mono = pol.prefill(pol.init_state(B, H, 96, D, device="cpu",
                                      ragged=True), k, v)
    ch = pol.init_state(B, H, 96, D, device="cpu", ragged=True)
    for lo, hi in ((0, 32), (32, 64), (64, 70)):
        pol.prefill_chunk(ch, k[..., lo:hi, :], v[..., lo:hi, :])
    want, got = _leaves(mono), _leaves(ch)
    assert want.keys() == got.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_policy_chunks_equal_monolithic_prefill_paged(policy):
    """Paged chunks (page-table-routed writes, the tail in the ring) hold
    the monolithic prefill's persistent bytes, read through the table."""
    pol = get_policy(policy)
    B, S, s_max = 2, 70, 96
    k, v = _kv(2, B, S)
    mono = pol.prefill(pol.init_state(B, H, s_max, D, device="cpu",
                                      ragged=True), k, v)
    pg = pol.init_paged(B, H, s_max, D, n_pages=2 * (s_max // PS) + 1,
                        page_size=PS, device="cpu")
    row = pol.init_state(1, H, s_max, D, device="cpu", ragged=True)
    for slot in range(B):
        pol.insert_row_paged(pg, row, slot, [], 0, s_max // PS)
    for lo, hi in ((0, 32), (32, 64), (64, 70)):
        pol.prefill_chunk(pg, k[..., lo:hi, :], v[..., lo:hi, :])
    int4 = policy == "int4-srft"
    pd = pg.data.kv if int4 else pg.data
    md = _leaves(mono)
    names = ("k_packed", "k_scales", "v_packed", "v_scales") if int4 \
        else ("k", "v")
    n_valid = (S // W) * W if int4 else S
    assert torch.equal(pd.length, md["length"])
    for view, name in zip(paged.gather_view(pd), names):
        assert torch.equal(view[:, :, :n_valid], md[name][:, :, :n_valid])
    if int4:
        assert torch.equal(pd.residual[0], md["k_residual"])
        assert torch.equal(pd.residual[1], md["v_residual"])


def test_prefill_chunk_rejects_scalar_states():
    for name in ("int4-srft", "bf16"):
        pol = get_policy(name)
        state = pol.init_state(1, 2, 32, 64, device="cpu")
        k = torch.zeros((1, 2, 16, 64), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="ragged"):
            pol.prefill_chunk(state, k, k)


def _pool_pair(policy, seed):
    """The same random pool bytes, page table and lengths in both
    packages: (reference PagedData, port PagedData)."""
    rng = np.random.default_rng(seed)
    jpol, pol = jcache_api.get_policy(policy), get_policy(policy)
    n_pages, s_max, B = 9, 64, 2
    js = jpol.init_paged(B, H, s_max, D, n_pages=n_pages, page_size=PS)
    ts = pol.init_paged(B, H, s_max, D, n_pages=n_pages, page_size=PS,
                        device="cpu")
    jd = js.data.kv if policy == "int4-srft" else js.data
    td = ts.data.kv if policy == "int4-srft" else ts.data
    pools = []
    for p in jd.pools:
        shape, dt = p.shape, np.asarray(p).dtype
        if dt == np.uint8:
            x = rng.integers(0, 256, shape).astype(np.uint8)
        else:
            x = np.asarray(jnp.asarray(rng.standard_normal(shape), p.dtype))
        pools.append(x)
    table = np.array([[3, 7, 1, 0], [5, 2, 8, 6]], np.int32)
    lengths = np.array([32, 48], np.int32)
    jd = jd._replace(pools=tuple(jnp.asarray(x) for x in pools),
                     page_table=jnp.asarray(table),
                     length=jnp.asarray(lengths))
    td.pools = tuple(_port_leaf(x) for x in pools)
    td.table_host.copy_(_t(table))
    td.upload_table()
    td.length.copy_(_t(lengths))
    return jd, td


def _assert_pools_equal(jd, td):
    """Every pool byte but the null page's (scratch: writes that hit no
    mapped page land there in either package)."""
    for j, t in zip(jd.pools, td.pools):
        np.testing.assert_array_equal(_bits(t)[1:], _bits(j)[1:])


@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_read_pages_write_chunk_append_chunk_equal_reference(policy):
    jd, td = _pool_pair(policy, seed=3 if policy == "bf16" else 4)
    pages = np.array([7, 0, 2, 5], np.int32)
    got = paged.read_pages(td, pages)
    want = jpaged.read_pages(jd, jnp.asarray(pages))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
        assert all(g.data_ptr() != p.data_ptr() for p in td.pools)
    got[0].fill_(0)  # a copy: the pool keeps its bytes
    np.testing.assert_array_equal(_bits(td.pools[0]), _bits(jd.pools[0]))

    rng = np.random.default_rng(5)
    C = 20  # crosses a page boundary
    vals = []
    for p in jd.pools:
        shape = (2, H, C, p.shape[-1])
        if np.asarray(p).dtype == np.uint8:
            vals.append(rng.integers(0, 256, shape).astype(np.uint8))
        else:
            vals.append(np.asarray(jnp.asarray(rng.standard_normal(shape),
                                               p.dtype)))
    starts = np.array([4, 29], np.int32)
    jd = jpaged.write_chunk(jd, tuple(jnp.asarray(x) for x in vals),
                            jnp.asarray(starts))
    paged.write_chunk(td, tuple(_port_leaf(x) for x in vals), _t(starts))
    _assert_pools_equal(jd, td)
    C2 = 16
    vals2 = tuple(x[:, :, :C2] for x in vals)
    jd = jpaged.append_chunk(jd, tuple(jnp.asarray(x) for x in vals2))
    paged.append_chunk(td, tuple(_port_leaf(x) for x in vals2))
    _assert_pools_equal(jd, td)
    np.testing.assert_array_equal(td.length.numpy(), np.asarray(jd.length))


def _bf16_ulp_gap(got: torch.Tensor, want: np.ndarray) -> tuple:
    """(max |got - want| in bf16 ulps of the larger magnitude, share of
    elements that differ), both cast to bf16."""
    g = got.bfloat16().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.bfloat16).astype(jnp.float32))
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    gap = np.abs(g - w) / ulp
    return float(gap.max()), float((g != w).mean())


@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_raw_kv_view_against_reference(policy):
    """A prefilled row read back in raw space over its first 48 tokens:
    bf16 bit-equal, int4 within one bf16 ulp of the reference's
    dequantize-then-``rot.inverse`` (share of flipped elements printed)."""
    jpol, pol = jcache_api.get_policy(policy), get_policy(policy)
    k, v = _kv(6, 1, 53)
    js = jpol.init_state(1, H, S_MAX, D, key=KEY, ragged=True)
    if policy == "int4-srft":  # a calibrated-looking lambda on both sides
        rng = np.random.default_rng(10)
        rk, rv = (type(r)(r.matrix, jnp.asarray(np.exp(
            0.3 * rng.standard_normal(D)), jnp.float32), r.signs, r.kind)
            for r in (js.data.rot_k, js.data.rot_v))
        js = jpol.with_rotations(js, rk, rv)
    js = jpol.prefill(js, jnp.asarray(k.float().numpy(), jnp.bfloat16),
                      jnp.asarray(v.float().numpy(), jnp.bfloat16))
    ts = pol.init_state(1, H, S_MAX, D, device="cpu", ragged=True)
    if policy == "int4-srft":
        d = js.data
        rots = [Rotation(_t(r.matrix), _t(r.lam), _t(r.signs), r.kind)
                for r in (d.rot_k, d.rot_v)]
        ts = pol.with_rotations(ts, *rots)
        for f in ("k_packed", "k_scales", "v_packed", "v_scales",
                  "k_residual", "v_residual", "length"):
            getattr(ts.data.kv, f).copy_(_t(getattr(d.kv, f)))
    else:
        pol.prefill(ts, k, v)
    n = 48
    want = jpol.raw_kv_view(js)
    got = pol.raw_kv_view(ts, n)
    full = pol.raw_kv_view(ts)
    for g, f, w in zip(got, full, want):
        w = np.asarray(w)[:, :, :n]
        assert g.shape == (1, H, n, D) and f.shape == (1, H, S_MAX, D)
        assert torch.equal(f[:, :, :n], g)
        if policy == "bf16":
            np.testing.assert_array_equal(_bits(g), _bits(w))
            continue
        gap, share = _bf16_ulp_gap(g, w)
        print(f"int4 raw_kv_view: {share:.2e} of elements flip, at most "
              f"{gap:.2f} bf16 ulp")
        assert gap <= 1.0, gap


def test_adopt_prefix_seeds_the_row_from_pages():
    """``adopt_prefix`` copies the named pages' bytes into a staging row
    (the reference's bytes at every adopted position), sets its length,
    and leaves the int4 residual ring at zero."""
    for policy in ("int4-srft", "bf16"):
        jd, td = _pool_pair(policy, seed=8)
        jpol, pol = jcache_api.get_policy(policy), get_policy(policy)
        jst = jpol.init_paged(2, H, 64, D, n_pages=9, page_size=PS)
        tst = pol.init_paged(2, H, 64, D, n_pages=9, page_size=PS,
                             device="cpu")
        if policy == "int4-srft":
            jst = jcache_api.CacheState(jpol, jst.data._replace(kv=jd))
            tst.data.kv = td
        else:
            jst, tst.data = jcache_api.CacheState(jpol, jd), td
        jrow = jpol.init_state(1, H, 64, D, key=KEY, ragged=True)
        trow = pol.init_state(1, H, 64, D, device="cpu", ragged=True)
        pages = np.array([5, 2], np.int32)
        jrow = jpol.adopt_prefix(jrow, jst, jnp.asarray(
            np.array([5, 2, 0, 0], np.int32)), jnp.int32(32))
        pol.adopt_prefix(trow, tst, pages, 32)
        jl = _leaves_j(jrow)
        tl = _leaves(trow)
        assert int(tl["length"][0]) == 32 == int(jl["length"][0])
        for name, t in tl.items():
            if name == "length":
                continue
            if name.endswith("residual"):
                assert not t.any()
                continue
            np.testing.assert_array_equal(_bits(t)[:, :, :32],
                                          _bits(jl[name])[:, :, :32])


def _leaves_j(state):
    d = state.data
    kv = getattr(d, "kv", d)
    return kv._asdict()


# ------------------------------------------------------------- model layer

@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(jget_config("smol-d64"), n_layers=2)
    tcfg = dataclasses.replace(get_config("smol-d64"), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = LM(tcfg, device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    return jm, jp, model, params


def _jrots(jstate):
    d = jstate.data
    return (Rotation(_t(d.rot_k.matrix), _t(d.rot_k.lam), _t(d.rot_k.signs),
                     d.rot_k.kind),
            Rotation(_t(d.rot_v.matrix), _t(d.rot_v.lam), _t(d.rot_v.signs),
                     d.rot_v.kind))


@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_lm_prefill_chunk_matches_reference_and_monolithic(lm, policy):
    """Three chunks (16, 16, 7) of a 39-token prompt: the port's last
    logits equal its own monolithic prefill's and every cache byte of it;
    against the reference's chunk chain, logits within LOGIT_TOL."""
    jm, jp, model, params = lm
    cfg = model.cfg
    prompt = np.random.default_rng(9).integers(0, 256, 39).astype(np.int32)
    jcache = jm.init_cache(1, S_MAX, policy=policy, key=KEY, ragged=True)
    rots = ([_jrots(jax.tree.map(lambda x, i=i: x[i], jcache["attn"]))
             for i in range(cfg.n_layers)] if policy == "int4-srft" else None)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, len(prompt), cfg.head_dim)
    jraw = [jnp.zeros(shape, jnp.bfloat16) for _ in "kv"]
    raw = [torch.zeros(shape, dtype=torch.bfloat16) for _ in "kv"]
    cache = model.init_cache(1, S_MAX, policy=policy, rots=rots, ragged=True)
    step = jax.jit(jm.prefill_chunk)
    for lo, hi in ((0, 16), (16, 32), (32, 39)):
        jlog, jcache, *jraw = step(jp, jnp.asarray(prompt[None, lo:hi]),
                                   jcache, *jraw)
        logits, cache, *raw = model.prefill_chunk(
            params, torch.from_numpy(prompt[None, lo:hi]).long(), cache,
            *raw)
    mono = model.init_cache(1, S_MAX, policy=policy, rots=rots, ragged=True)
    mlog, mono = model.prefill(params, torch.from_numpy(prompt[None]).long(),
                               mono)
    assert torch.equal(logits, mlog)
    assert torch.equal(cache["pos"], mono["pos"])
    for st, ms in zip(cache["attn"], mono["attn"]):
        a, b = _leaves(st), _leaves(ms)
        for name in a:
            assert torch.equal(a[name], b[name]), name
    jl = np.asarray(jlog, np.float32)
    err = np.abs(logits.numpy() - jl).max()
    assert err <= LOGIT_TOL * np.abs(jl).max(), err


# ------------------------------------------------------------ engine layer

def _prompts(lens, seed=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _reqs(lens=(9, 37, 23), news=(12, 10, 7), seed=40, cls=Request):
    return [cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(lens, seed), news))]


def _run(model, params, reqs, *, capacity=3, s_max=S_MAX, **kw):
    eng = BatchEngine(model, params, capacity=capacity, s_max=s_max,
                      kv_block=PS, chunk=4, page_size=PS, device="cpu", **kw)
    return eng, {c.rid: c for c in eng.run(list(reqs))}


def _forced(model, params, policy, backend, prompt, toks, rots):
    """The request alone (monolithic, eager), teacher-forced on ``toks``:
    its logits at every step, for the near-tie rule."""
    cache = model.init_cache(1, S_MAX, policy=policy, rots=rots)
    lg, cache = model.prefill(params, torch.as_tensor(prompt[None]).long(),
                              cache)
    out = [lg[0, -1]]
    for t in toks[:-1]:
        lg, cache = model.decode_step(params, torch.tensor([[int(t)]]),
                                      cache, backend=backend, kv_block=PS)
        out.append(lg[0, -1])
    return torch.stack(out).numpy()


def _agree_up_to_tie(ref, got, logits, what):
    ref, got = np.asarray(ref), np.asarray(got)
    assert len(ref) == len(got), what
    diff = np.nonzero(ref != got)[0]
    if not len(diff):
        return
    i = int(diff[0])
    top2 = np.sort(np.asarray(logits[i], np.float32))[-2:]
    tol = LOGIT_TOL * np.abs(np.asarray(logits)).max()
    assert top2[1] - top2[0] < tol, f"{what}: diverge at step {i}"


@pytest.mark.parametrize("policy,backend,paged", [
    ("int4-srft", "gather", False), ("int4-srft", "kernel", True),
    ("bf16", "gather", True), ("bf16", "blockwise", False)])
def test_chunked_engine_equals_monolithic(lm, policy, backend, paged):
    """Prompts that share no prefix: chunked admission (budget of one
    chunk, several quanta per admission) gives the monolithic engine's
    tokens exactly, and returns every page."""
    _, _, model, params = lm
    kw = dict(policy=policy, backend=backend, paged=paged)
    _, mono = _run(model, params, _reqs(), **kw)
    eng, ch = _run(model, params, _reqs(), prefill_chunk=PS,
                   prefill_budget=PS, **kw)
    assert eng.n_prefill_chunks == 1 + 3 + 2
    assert eng.n_reused_tokens == 0
    for i in range(3):
        np.testing.assert_array_equal(ch[i].tokens, mono[i].tokens)
        assert ch[i].finish_reason == mono[i].finish_reason == "length"
    if paged:
        assert eng.pool_stats()["pages_used"] == 0
        assert eng.n_reuse_misses == 3 and eng.n_reuse_hits_device == 0


def test_chunked_engine_matches_reference(lm):
    """The reference's chunked engine on the same requests, weights and
    rotations: streams agree up to a near-tie, and both count the same
    chunks."""
    jm, jp, model, params = lm
    jeng = JBatchEngine(jm, jp, capacity=3, s_max=S_MAX, policy="int4-srft",
                        backend="gather", kv_block=PS, chunk=4, key=KEY,
                        paged=True, page_size=PS, prefill_chunk=PS)
    want = {c.rid: c for c in jeng.run(_reqs(cls=JRequest))}
    d = jeng.cache["attn"].data
    rots = bridge.rotations({
        side: {f: np.asarray(getattr(getattr(d, f"rot_{side}"), f))
               for f in ("matrix", "lam", "signs")} for side in ("k", "v")})
    eng, got = _run(model, params, _reqs(), policy="int4-srft",
                    backend="gather", paged=True, prefill_chunk=PS, rots=rots)
    assert eng.n_prefill_chunks == jeng.n_prefill_chunks
    for r in _reqs():
        _agree_up_to_tie(want[r.rid].tokens, got[r.rid].tokens,
                         _forced(model, params, "int4-srft", "gather",
                                 r.prompt, want[r.rid].tokens, rots),
                         f"request {r.rid}")


def _shared_reqs(n, prefix_len, seed=90, new=6):
    prefix = np.random.default_rng(seed).integers(0, 256, prefix_len)
    return [Request(rid=i, prompt=np.concatenate(
        [prefix, [100 + i]]).astype(np.int32), max_new_tokens=new)
        for i in range(n)]


def test_token_level_reuse_skips_shared_chunks(lm):
    """Three prompts sharing 37 tokens: the later two seed the W-aligned 32
    from the first one's pages (no prefill compute, two int4 raw views
    through B4's plain version), the two full prefix pages carry one
    reference per sharer, and each later admission prefills 6 tokens."""
    _, _, model, params = lm
    eng = BatchEngine(model, params, capacity=3, s_max=S_MAX,
                      policy="int4-srft", backend="gather", kv_block=PS,
                      chunk=4, paged=True, page_size=PS, prefill_chunk=PS,
                      device="cpu")
    for r in _shared_reqs(3, 37, new=12):
        eng.submit(r)
    max_shared_3 = 0
    while eng.has_work:
        eng.step()
        max_shared_3 = max(max_shared_3,
                           int((eng._refcount_host == 3).sum()))
    assert max_shared_3 == 37 // PS
    assert eng.n_reused_tokens == 2 * 32
    assert eng.n_prefill_chunks == 3 + 2
    assert (eng.n_reuse_hits_device, eng.n_reuse_misses) == (2, 1)
    assert eng.pool_stats()["pages_used"] == 0


def test_token_level_reuse_is_bit_exact_for_bf16(lm):
    """bf16 pages hold the raw K/V bytes (W = 1: token granularity), so
    reuse changes nothing: the streams of a no-reuse run, bit for bit."""
    _, _, model, params = lm
    reqs = _shared_reqs(3, 37, seed=91)
    kw = dict(capacity=3, policy="bf16", backend="gather", paged=True,
              prefill_chunk=PS)
    eng_off, off = _run(model, params, reqs, prefix_reuse=False, **kw)
    eng_on, on = _run(model, params, reqs, **kw)
    assert eng_off.n_reused_tokens == 0
    assert eng_on.n_reused_tokens == 2 * 37
    for i in range(3):
        np.testing.assert_array_equal(on[i].tokens, off[i].tokens)


def test_reuse_needs_a_full_page(lm):
    _, _, model, params = lm
    eng, _ = _run(model, params, _shared_reqs(2, PS - 2, seed=92),
                  capacity=2, policy="bf16", backend="gather", paged=True,
                  prefill_chunk=PS)
    assert eng.n_reused_tokens == 0 and eng.n_reuse_misses == 2


def test_chunked_survives_preemption(lm):
    """An undersized pool preempts under chunked admission (the pending
    slot is never a victim); every stitched stream has its full length
    and agrees with the dense monolithic engine's up to a near-tie, the
    rule ``tests/test_torch_batch_engine.py`` holds monolithic preemption
    to (a continuation's recompute prefills tokens that the first run
    decoded one at a time, which rounds otherwise in the eager port), and
    every page comes back."""
    _, _, model, params = lm
    reqs = _reqs(lens=(9, 20), news=(10, 8), seed=60)
    kw = dict(capacity=2, s_max=48, policy="int4-srft", backend="gather")
    mono_eng, mono = _run(model, params, reqs, paged=False, **kw)
    eng, ch = _run(model, params, reqs, paged=True, n_pages=4,
                   prefill_chunk=PS, **kw)
    assert eng.n_preemptions > 0
    for r in reqs:
        assert len(ch[r.rid].tokens) == r.max_new_tokens
        _agree_up_to_tie(mono[r.rid].tokens, ch[r.rid].tokens,
                         _forced(model, params, "int4-srft", "gather",
                                 r.prompt, mono[r.rid].tokens,
                                 mono_eng._rots), f"request {r.rid}")
    assert eng.pool_stats()["pages_used"] == 0


def test_chunked_admission_keeps_every_buffer_in_place(lm):
    """Admission with reuse writes the slot cache in place: every cache
    leaf, length, ``pos`` and step buffer keeps its storage (a captured
    decode step replays them)."""
    _, _, model, params = lm
    eng = BatchEngine(model, params, capacity=2, s_max=S_MAX,
                      policy="int4-srft", backend="gather", kv_block=PS,
                      chunk=4, paged=True, page_size=PS, prefill_chunk=PS,
                      device="cpu")

    def ptrs():
        out = {"pos": eng.cache["pos"], "tok": eng.tok}
        for i, st in enumerate(eng.cache["attn"]):
            kv = st.data.kv
            for j, t in enumerate((*kv.pools, *kv.residual, kv.page_table,
                                   kv.length)):
                out[f"{i}.{j}"] = t
        return {k: t.data_ptr() for k, t in out.items()}

    before = ptrs()
    for r in _shared_reqs(3, 37, seed=93):
        eng.submit(r)
    while eng.has_work:
        eng.step()
        assert ptrs() == before
    assert eng.n_reused_tokens > 0


def test_chunked_validation_and_cancel(lm):
    _, _, model, params = lm
    kw = dict(capacity=1, s_max=S_MAX, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        BatchEngine(model, params, policy="int4-srft", prefill_chunk=0, **kw)
    with pytest.raises(ValueError, match="flush window"):
        BatchEngine(model, params, policy="int4-srft", prefill_chunk=10,
                    **kw)
    with pytest.raises(ValueError, match="page_size"):
        BatchEngine(model, params, policy="bf16", paged=True, page_size=PS,
                    prefill_chunk=8, **kw)
    with pytest.raises(ValueError, match="prefill_budget"):
        BatchEngine(model, params, policy="bf16", prefill_chunk=1,
                    prefill_budget=0, **kw)
    with pytest.raises(ValueError, match="prefill_chunk too"):
        BatchEngine(model, params, policy="bf16", prefill_budget=64, **kw)
    eng = BatchEngine(model, params, policy="bf16", paged=True, page_size=PS,
                      prefill_chunk=PS, **kw)
    for r in _reqs(lens=(37, 9), news=(4, 4)):
        eng.submit(r)
    eng.step()  # one chunk of the 37-token prompt: pending
    assert eng.pending == 2 and eng.n_active == 0 and eng.n_free_slots == 0
    done = eng.cancel_all()
    assert sorted(c.rid for c in done) == [0, 1]
    assert not eng.has_work and eng.n_free_slots == 1
    assert eng.pool_stats()["pages_used"] == 0
