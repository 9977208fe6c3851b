"""The BLOCKWISE read path (ROADMAP A2): the port's
``decode_attention_quant_blockwise`` and ``decode_attention_bf16_blockwise``
against the reference's (``repro/core/quant_attention_ref.py:133, :272``)
and against the port's own GATHER read, on the same cache bytes: dense
with a shared length, ragged with per-row lengths (an empty row among
them) and paged through a shuffled page table; with and without a
``sliding_window``; with a ``kv_block`` that divides ``s_max`` and one that
does not (the last tile's start is clamped and the rows an earlier tile
covered are masked).  Then ``Engine`` and ``BatchEngine`` with
``backend="blockwise"`` against GATHER.  CPU, plain PyTorch.

Tolerances.  Outputs are O(1) and every read sums in fp32: the port's
einsums and the reference's (XLA) sum in other orders, and BLOCKWISE's
online softmax rescales where GATHER takes one softmax, so outputs agree
within ATOL = 2e-5, the bound the int4 GATHER/KERNEL tests use.  One
difference is by design: on a row of length 0 the port's bf16 BLOCKWISE
weighs every masked position exactly zero (a zero output, as bf16 GATHER
gives), where the reference's tiles return the mean of the masked values;
the test asserts the zero and compares the other rows.  An empty int4
row reads a mean of masked values in both packages (compared with the
reference), which GATHER weighs otherwise (not compared with GATHER).
Engine logits follow ``tests/test_torch_engine.py``: within LOGIT_TOL of
the largest GATHER logit, tokens equal up to a near-tie."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cache_api as jcache_api  # noqa: E402
from repro.core import kvcache as jkv  # noqa: E402
from repro.core import quant_attention_ref as jqa  # noqa: E402
from repro.core import transforms as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import kvcache  # noqa: E402
from repro_torch.core import quant_attention_ref as qa  # noqa: E402
from repro_torch.core.cache_api import AttendBackend, get_policy  # noqa: E402
from repro_torch.core.transforms import Rotation  # noqa: E402
from repro_torch.launch.batch_engine import BatchEngine, Request  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ATOL = 2e-5
LOGIT_TOL = 0.05  # tests/test_torch_engine.py
B, HKV, HQ, D, S_MAX, GROUP, W, PS = 4, 2, 4, 64, 96, 32, 16, 16
ROW_LENGTHS = (0, 15, 53, 90)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rots(seed):
    """(reference, port) rotation pairs with a non-trivial lambda."""
    out = []
    for i in range(2):
        r = jtf.make_rotation("srft", jax.random.PRNGKey(seed + i), D)
        lam = np.exp(0.3 * np.random.default_rng(seed + i)
                     .standard_normal(D)).astype(np.float32)
        r = jtf.Rotation(r.matrix, jnp.asarray(lam), r.signs, r.kind)
        out.append((r, Rotation(_t(r.matrix), _t(r.lam), _t(r.signs),
                                r.kind)))
    return out


def _leaves(policy, rng, rows, s):
    """Random seq-major leaves (rows, H, s, c) in the policy's pool order,
    and the int4 residual windows."""
    if policy == "bf16":
        kv = [rng.standard_normal((rows, HKV, s, D)).astype(np.float32)
              for _ in "kv"]
        return [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in kv], []
    leaves = []
    for _ in "kv":
        leaves += [rng.integers(0, 256, (rows, HKV, s, D // 2)).astype(
            np.uint8), (rng.random((rows, HKV, s, D // GROUP)) * 0.3).astype(
            np.float32)]
    res = [rng.standard_normal((B, HKV, W, D)).astype(np.float32)
           for _ in "kv"]
    return leaves, res


def _bf16_t(x):
    return torch.from_numpy(np.array(x).view(np.uint16)).view(
        torch.bfloat16)


def _port_leaf(x):
    return _bf16_t(x) if np.asarray(x).dtype.name == "bfloat16" else _t(x)


def _states(policy, layout, seed):
    """The same cache in both packages: (reference state, port state)."""
    rng = np.random.default_rng(seed)
    jpol, pol = jcache_api.get_policy(policy), get_policy(policy)
    rots = _rots(seed) if policy == "int4-srft" else None
    if layout == "paged":
        leaves, res = _leaves(policy, rng, 1, (B * S_MAX // PS + 1) * PS)
        pools = [np.ascontiguousarray(
            x[0].reshape(HKV, -1, PS, x.shape[-1]).transpose(1, 0, 2, 3))
            for x in leaves]
        n_pages = pools[0].shape[0]
        perm = rng.permutation(np.arange(1, n_pages))
        table = np.zeros((B, S_MAX // PS), np.int32)
        for b, n in enumerate(ROW_LENGTHS):
            need = -(-n // PS)
            table[b, :need], perm = perm[:need], perm[need:]
        lengths = np.asarray(ROW_LENGTHS, np.int32)
        js = jpol.init_paged(B, HKV, S_MAX, D, n_pages=n_pages,
                             page_size=PS)
        ts = pol.init_paged(B, HKV, S_MAX, D, n_pages=n_pages, page_size=PS,
                            device="cpu")
        jd = js.data.kv if rots else js.data
        jd = jd._replace(pools=tuple(jnp.asarray(p) for p in pools),
                         residual=tuple(jnp.asarray(r) for r in res),
                         page_table=jnp.asarray(table),
                         length=jnp.asarray(lengths))
        td = ts.data.kv if rots else ts.data
        td.pools = tuple(_port_leaf(p) for p in pools)
        td.residual = tuple(_t(r) for r in res)
        td.table_host.copy_(_t(table))
        td.upload_table()
        td.length.copy_(_t(lengths))
    else:
        leaves, res = _leaves(policy, rng, B, S_MAX)
        ragged = layout == "ragged"
        lengths = np.asarray(ROW_LENGTHS, np.int32) if ragged else 70
        js = jpol.init_state(B, HKV, S_MAX, D, ragged=ragged)
        ts = pol.init_state(B, HKV, S_MAX, D, ragged=ragged, device="cpu")
        jl = jnp.asarray(lengths, jnp.int32)
        tl = _t(lengths) if ragged else lengths
        if rots:
            jd = jkv.QuantKVCache(*(jnp.asarray(x) for x in leaves + res),
                                  jl)
            td = kvcache.QuantKVCache(*(_t(x) for x in leaves + res), tl)
        else:
            jd = jkv.BF16KVCache(*(jnp.asarray(x) for x in leaves), jl)
            td = kvcache.BF16KVCache(*(_port_leaf(x) for x in leaves), tl)
    if rots:
        (jrk, trk), (jrv, trv) = rots
        js = jcache_api.CacheState(jpol, jcache_api.Int4State(jd, jrk, jrv))
        ts.data.kv = td
        ts = pol.with_rotations(ts, trk, trv)
    else:
        js = jcache_api.CacheState(jpol, jd)
        ts.data = td
    return jpol, js, pol, ts


def _live_rows(layout):
    return [b for b in range(B)
            if layout == "dense" or ROW_LENGTHS[b] > 0]


@pytest.mark.parametrize("kv_block", [40])
@pytest.mark.parametrize("sliding_window", [None, 24])
@pytest.mark.parametrize("layout", ["dense", "ragged", "paged"])
@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_blockwise_matches_reference_and_gather(policy, layout,
                                                sliding_window, kv_block):
    jpol, js, pol, ts = _states(policy, layout, seed=len(layout) + kv_block)
    q = np.random.default_rng(kv_block).standard_normal(
        (B, HQ, 1, D)).astype(np.float32)
    kw = dict(kv_block=kv_block, sliding_window=sliding_window)
    ref = np.asarray(jpol.attend(jnp.asarray(q), js, backend="blockwise",
                                 **kw))
    got = pol.attend(_t(q), ts, backend=AttendBackend.BLOCKWISE, **kw)
    gat = pol.attend(_t(q), ts, backend="gather",
                     sliding_window=sliding_window)
    assert got.shape == (B, HQ, 1, D) and torch.isfinite(got).all()
    live = _live_rows(layout)
    rows = live if policy == "bf16" else list(range(B))
    np.testing.assert_allclose(got.numpy()[rows], ref[rows], atol=ATOL)
    # an empty row's int4 output is a mean of masked values, which the
    # two tilings weigh differently (a clamped last tile counts some twice)
    np.testing.assert_allclose(got.numpy()[live], gat.numpy()[live],
                               atol=ATOL)
    if policy == "bf16" and layout != "dense":
        assert (got[0] == 0).all(), "an empty row reads exactly zero"


@pytest.mark.parametrize("kv_block", [32, 512])
def test_blockwise_functions_match_reference_directly(kv_block):
    """The two functions called as they are (no policy dispatch) on a
    scalar cache, with a ``kv_block`` that divides ``s_max`` and one
    larger than it (one tile)."""
    for policy in ("int4-srft", "bf16"):
        jpol, js, pol, ts = _states(policy, "dense", seed=3)
        q = np.random.default_rng(4).standard_normal(
            (B, HQ, 1, D)).astype(np.float32)
        if policy == "bf16":
            ref = jqa.decode_attention_bf16_blockwise(
                jnp.asarray(q), js.data, kv_block=kv_block)
            got = qa.decode_attention_bf16_blockwise(_t(q), ts.data,
                                                     kv_block=kv_block)
        else:
            jd, td = js.data, ts.data
            ref = jqa.decode_attention_quant_blockwise(
                jnp.asarray(q), jd.kv, jd.rot_k, jd.rot_v, kv_block=kv_block)
            got = qa.decode_attention_quant_blockwise(
                _t(q), td.kv, td.rot_k, td.rot_v, kv_block=kv_block)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_blockwise_is_listed_and_kernel_stays_int4_only():
    assert AttendBackend.parse("blockwise") is AttendBackend.BLOCKWISE
    for name in ("bf16", "int4-srft"):
        assert AttendBackend.BLOCKWISE in get_policy(name).supported_backends
    bf = get_policy("bf16")
    with pytest.raises(NotImplementedError, match="gather, blockwise"):
        bf.attend(torch.zeros(1, 2, 1, 64),
                  bf.init_state(1, 1, 32, 64, device="cpu"),
                  backend="kernel")


# ------------------------------------------------------------- the engines

@pytest.fixture(scope="module")
def lm():
    model = LM(get_config("smol-d64"), device="cpu")
    return model, model.init(model.generator(0))


def _agree_up_to_tie(ref_toks, got_toks, ref_logits, what):
    diff = np.nonzero(np.asarray(ref_toks) != np.asarray(got_toks))[0]
    if not len(diff):
        return len(ref_toks)
    i = int(diff[0])
    top2 = np.sort(np.asarray(ref_logits[i], np.float32))[-2:]
    tol = LOGIT_TOL * np.abs(np.asarray(ref_logits)).max()
    assert top2[1] - top2[0] < tol, f"{what}: diverge at {i}"
    return i


@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_engine_blockwise_matches_gather(lm, policy):
    """``Engine(backend="blockwise")`` on a ragged batch-1 cache and on a
    plain batch-2 cache: logits within LOGIT_TOL of GATHER's, tokens equal
    up to a near-tie."""
    model, params = lm
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 27)).astype(np.int64))
    for prompt, ragged in ((toks[:1], True), (toks, False)):
        out = {}
        for backend in ("gather", "blockwise"):
            cache = model.init_cache(prompt.shape[0], 64, policy=policy,
                                     ragged=ragged)
            out[backend] = Engine(model, backend=backend,
                                  kv_block=16).generate(
                params, prompt, cache, 20, return_logits=True)
        (tg, lg, _), (tb, lb, _) = out["gather"], out["blockwise"]
        for b in range(prompt.shape[0]):
            n = _agree_up_to_tie(tg[b].numpy(), tb[b].numpy(),
                                 lg[b].numpy(), f"{policy} row {b}")
            err = (lb[b, :n + 1] - lg[b, :n + 1]).abs().max().item()
            assert err <= LOGIT_TOL * lg.abs().max().item(), err


@pytest.mark.parametrize("paged", [False, True])
def test_batch_engine_blockwise_matches_gather(lm, paged):
    model, params = lm
    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(0, 256, n).astype(np.int32), m)
            for i, (n, m) in enumerate(((9, 8), (37, 10), (23, 12)))]
    out = {}
    for backend in ("gather", "blockwise"):
        eng = BatchEngine(model, params, capacity=2, s_max=64,
                          policy="int4-srft", backend=backend, kv_block=16,
                          chunk=4, paged=paged, page_size=16, device="cpu")
        out[backend] = {c.rid: c.tokens for c in eng.run(list(reqs))}
    for r in reqs:
        ref, got = out["gather"][r.rid], out["blockwise"][r.rid]
        if not np.array_equal(ref, got):  # judge on the forced logits
            _agree_up_to_tie(ref, got, _forced(model, params, r.prompt, ref,
                                               eng._rots), f"req {r.rid}")


def _forced(model, params, prompt, toks, rots):
    """The request alone, teacher-forced on ``toks`` (GATHER): its logits
    at every step."""
    cache = model.init_cache(1, 64, policy="int4-srft", rots=rots)
    lg, cache = model.prefill(params, torch.as_tensor(prompt[None]).long(),
                              cache)
    out = [lg[0, -1]]
    for t in toks[:-1]:
        lg, cache = model.decode_step(params, torch.tensor([[int(t)]]),
                                      cache, kv_block=16)
        out.append(lg[0, -1])
    return torch.stack(out).numpy()
