"""Self-speculative decoding (ROADMAP A5) in the port against the reference
(``repro/launch/engine.py:129, :325-460``, ``repro/core/kvcache.py:418,
:449``, ``repro/core/paged.py:427``, ``repro/core/quant_attention_ref.py:
357-478``, ``repro/core/cache_api.py:698-720, :1012-1065``,
``repro/models/attention.py:215``, ``repro/models/lm.py:334, :678, :716``,
``repro/launch/batch_engine.py``), and the reference's own oracles
(``tests/test_spec_decode.py``) proven within the port.  CPU, smol-d64
cut to 2 layers, plain kernel versions; inputs from numpy seeds, params
and rotations carried across by ``repro_torch.bridge``.

Tolerances.  Within the port, speculative decoding equals plain greedy
decoding bit for bit: tokens, finish reasons, and the logits of a verify
pass against the sequential steps'.  A verify query runs a decode step's
read in its order and at its shapes; the k-row projections round each row
as the 1-row ones do under bf16 operands (the card's mode; the logit test
runs there), while the CPU's fp32 product of one row (a gemv) rounds
otherwise than the same row inside a larger product, so there only the
tokens are compared.  Across packages: the drafter, the ring rewind, the
truncations and the page tables are equal bit for bit; the verify reads
are within VERIFY_ATOL of the reference's on the same cache bytes (fp32
sums in another order); engine streams agree up to a near-tie
(``tests/test_torch_engine.py``'s rule: the reference keeps bf16
intermediates in fp32 under ``jit``)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import warnings  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import cache_api as jcache_api  # noqa: E402
from repro.core import kvcache as jkvcache  # noqa: E402
from repro.core import paged as jpaged  # noqa: E402
from repro.core import quant_attention_ref as jqar  # noqa: E402
from repro.core.transforms import Rotation as JRotation  # noqa: E402
from repro.launch.batch_engine import BatchEngine as JBatchEngine  # noqa: E402
from repro.launch.batch_engine import Request as JRequest  # noqa: E402
from repro.launch.engine import Engine as JEngine  # noqa: E402
from repro.launch.engine import Sampler as JSampler  # noqa: E402
from repro.launch.engine import draft_tokens as jdraft_tokens  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cache_api, kvcache, paged  # noqa: E402
from repro_torch.core.cache_api import AttendBackend, get_policy  # noqa: E402
from repro_torch.core.quant_attention_ref import (  # noqa: E402
    verify_attention_bf16,
    verify_attention_quant,
)
from repro_torch.kernels import quant_attention  # noqa: E402
from repro_torch.launch.batch_engine import BatchEngine, Request  # noqa: E402
from repro_torch.launch.engine import Engine, Sampler, draft_tokens  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

POLICIES = ["int4-srft", "bf16"]
LOGIT_TOL = 0.05  # of the largest logit: the near-tie rule across packages
VERIFY_ATOL = 2e-6  # verify reads vs the reference's, outputs O(1) fp32
NEW, S_MAX = 13, 64
H, HQ, D = 2, 4, 16  # policy-level tests


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    """smol-d64 cut to 2 layers in both packages, the reference's params
    bridged, and a repetitive prompt so that the drafter hits (the
    reference's ``tests/test_spec_decode.py:47-56``)."""
    jcfg = dataclasses.replace(jget_config("smol-d64"), n_layers=2)
    cfg = dataclasses.replace(get_config("smol-d64"), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    base = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 6))
    toks = np.tile(base, (1, 5))[:, :23].astype(np.int32)
    return jm, jp, model, params, toks


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _j(t: torch.Tensor):
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------------- drafter

@pytest.mark.parametrize("k", [2, 5])
def test_draft_tokens_equal_reference_scalar_and_ragged(k):
    """Scalar and per-row history lengths give the reference's drafts,
    and the per-row path proposes row by row what the scalar one does."""
    rng = np.random.default_rng(k)
    hist = rng.integers(0, 7, size=(3, 24)).astype(np.int32)
    for hl in (1, 2, 3, 9, 17, 24):
        got = draft_tokens(_t(hist).long(), hl, k)
        want = jdraft_tokens(jnp.asarray(hist), jnp.int32(hl), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        ragged = draft_tokens(_t(hist).long(), torch.full((3,), hl), k)
        assert torch.equal(ragged, got)
    per_row = np.array([4, 11, 23], np.int32)
    got = draft_tokens(_t(hist).long(), _t(per_row).long(), k)
    want = jdraft_tokens(jnp.asarray(hist), jnp.asarray(per_row), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b, hl in enumerate(per_row):
        one = draft_tokens(_t(hist[b:b + 1]).long(), int(hl), k)
        assert torch.equal(got[b:b + 1], one)


# ----------------------------------------------------- rewind / truncate

@pytest.mark.parametrize("ragged", [False, True], ids=["shared", "ragged"])
def test_rewind_residual_and_truncate_rows_equal_reference(ragged):
    """The same final ring, snapshot and lengths: the port's in-place
    rewind gives the reference's ring bit for bit, for every rewind
    target from L0 to L0 + k."""
    rng = np.random.default_rng(2)
    W, B = 8, 3
    final = rng.standard_normal((B, H, W, D)).astype(np.float32)
    snap = rng.standard_normal((B, H, W, D)).astype(np.float32)
    base = np.array([5, 14, 0], np.int32) if ragged else np.int32(6)
    for m in range(0, 5):
        new = (base + np.array([m, max(m - 1, 0), min(m, 2)], np.int32)
               if ragged else np.int32(base + m))
        want = jkvcache.rewind_residual(jnp.asarray(final), jnp.asarray(snap),
                                        jnp.asarray(base), jnp.asarray(new))
        got = _t(final)
        kvcache.rewind_residual(got, _t(snap), _t(base) if ragged
                                else int(base), _t(new) if ragged
                                else int(new))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # truncate_rows: both rings and the lengths, packed storage untouched
    S = 32
    packed = rng.integers(0, 256, (B, H, S, D // 2)).astype(np.uint8)
    scales = rng.standard_normal((B, H, S, D // 8)).astype(np.float32)
    length = (base + 4).astype(np.int32)
    new = (base + np.array([1, 4, 0], np.int32)) if ragged \
        else np.int32(base + 2)
    jc = jkvcache.QuantKVCache(*(jnp.asarray(x) for x in (
        packed, scales, packed, scales, final, final)), jnp.asarray(length))
    want = jkvcache.truncate_rows(jc, jnp.asarray(new), jnp.asarray(snap),
                                  jnp.asarray(snap), jnp.asarray(base))
    tc = kvcache.QuantKVCache(*(_t(x) for x in (
        packed, scales, packed, scales, final, final)),
        _t(length) if ragged else int(length))
    kvcache.truncate_rows(tc, _t(new) if ragged else int(new), _t(snap),
                          _t(snap), _t(base) if ragged else int(base))
    for f in jkvcache.QuantKVCache._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tc, f)),
                                      np.asarray(getattr(want, f)), f)


def _fill(pol, state, L0s, seed):
    """Row b appends L0s[b] tokens through ``update`` with an active mask
    (the serving path's writes)."""
    rng = np.random.default_rng(seed)
    B = len(L0s)
    for t in range(max(L0s, default=0)):
        k, v = (torch.from_numpy(rng.standard_normal((B, H, 1, D)).astype(
            np.float32)) for _ in "kv")
        pol.update(state, k, v,
                   active=torch.tensor([t < L for L in L0s]))
    return state


def _seeded_state(pol, paged_, L0s, W, seed, s_max=32):
    """A ragged (or paged: page size W, every page mapped) state with per
    row lengths ``L0s``, and a seeded rotation when int4."""
    B = len(L0s)
    g = torch.Generator().manual_seed(seed)
    if paged_:
        state = pol.init_paged(B, H, s_max, D, n_pages=B * (s_max // W) + 2,
                               page_size=W, generator=g, device="cpu")
        row = pol.init_state(1, H, s_max, D, device="cpu", ragged=True)
        for b in range(B):
            pol.insert_row_paged(state, row, b, [], 0, s_max // W)
    else:
        state = pol.init_state(B, H, s_max, D, generator=g, device="cpu",
                               ragged=True)
    return _fill(pol, state, L0s, seed)


def _live(pol, state) -> list:
    """Every live leaf of a state (cloned), the packed bytes through the
    page table when paged."""
    d = state.data
    kv = getattr(d, "kv", d)
    if state.is_paged:
        return [t.clone() for t in (*paged.gather_view(kv), *kv.residual,
                                    kv.length)]
    return [t.clone() for t in vars(kv).values()
            if isinstance(t, torch.Tensor)]


def _check_truncate_roundtrip(policy, paged_, L0s, ms, k_spec, W, seed):
    """Snapshot, k_spec appends, truncate to L0 + m: the state then reads
    as one that appended only the kept m tokens (one more update and a
    GATHER read, bitwise), and its rings and lengths equal the
    reference's ``truncate_rows`` applied to the same bytes."""
    pol = get_policy(policy, group=8, window=W)
    state = _seeded_state(pol, paged_, L0s, W, seed)
    ref = _seeded_state(pol, paged_, L0s, W, seed)
    B = len(L0s)
    rng = np.random.default_rng(seed + 7)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    ks = [draw(B, H, 1, D) for _ in range(k_spec)]
    vs = [draw(B, H, 1, D) for _ in range(k_spec)]

    snap = pol.snapshot_rows(state)
    for j in range(k_spec):
        pol.update(state, ks[j], vs[j])
    before = _live(pol, state)
    L0 = snap[-1] if isinstance(snap, tuple) else snap
    new = L0 + torch.tensor(ms, dtype=L0.dtype)
    pol.truncate_rows(state, new, snap)

    # the reference's truncate_rows on the same bytes
    jpol = jcache_api.get_policy(policy, group=8, window=W)
    int4 = policy == "int4-srft"
    jsnap = tuple(_j(t) for t in snap) if int4 else _j(snap)
    if int4 and paged_:
        jd = jpol.init_paged(B, H, 32, D, n_pages=B * (32 // W) + 2,
                             page_size=W)
        jd = jcache_api.CacheState(jpol, jd.data._replace(
            kv=jd.data.kv._replace(residual=(_j(before[4]), _j(before[5])),
                                   length=_j(before[6]))))
        want = jpol.truncate_rows(jd, _j(new), jsnap).data.kv
        got_rings = state.data.kv.residual
        want_rings = want.residual
    elif int4:
        js = jpol.init_state(B, H, 32, D, ragged=True)
        kv = jkvcache.QuantKVCache(*(_j(t) for t in before))
        want = jpol.truncate_rows(jcache_api.CacheState(
            jpol, js.data._replace(kv=kv)), _j(new), jsnap).data.kv
        got_rings = (state.data.kv.k_residual, state.data.kv.v_residual)
        want_rings = (want.k_residual, want.v_residual)
    else:
        js = jpol.init_state(B, H, 32, D, ragged=True)
        want = jpol.truncate_rows(js, _j(new), jsnap).data
        got_rings = want_rings = ()
    for g, w in zip(got_rings, want_rings):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(state.length.numpy(),
                                  np.asarray(want.length))

    # the port's own oracle: as if only the kept tokens were appended
    m = torch.tensor(ms)
    for j in range(k_spec):
        pol.update(ref, ks[j], vs[j], active=m > j)
    k_next, v_next, q_next = draw(B, H, 1, D), draw(B, H, 1, D), \
        draw(B, HQ, 1, D)
    o_t = pol.attend(q_next, pol.update(state, k_next, v_next),
                     backend=AttendBackend.GATHER)
    o_r = pol.attend(q_next, pol.update(ref, k_next, v_next),
                     backend=AttendBackend.GATHER)
    assert torch.equal(o_t, o_r)


TRUNC_GRID = [
    # L0s, kept m per row, k_spec, W (the reference's grid)
    ([5, 8, 0], [2, 1, 0], 3, 4),
    ([5, 3, 12], [4, 0, 3], 4, 4),  # the rewind crosses a flush at 8
    ([7, 15, 1], [1, 8, 5], 8, 8),  # a full-window pass, W = 8
    ([0, 6], [1, 2], 2, 16),
]


@pytest.mark.parametrize("paged_", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", range(len(TRUNC_GRID)))
def test_grid_truncate_roundtrip(policy, paged_, case):
    L0s, ms, k_spec, W = TRUNC_GRID[case]
    _check_truncate_roundtrip(policy, paged_, L0s, ms, k_spec, W, seed=case)


@pytest.mark.parametrize("paged_", [False, True], ids=["dense", "paged"])
def test_grid_flush_boundary_rewind(paged_):
    """L0 = 5, W = 4: the appends flush at 8 and the rewind to 6 pulls the
    packed length back to 4; the slab at [4, 8) must be unobservable
    again (ring restored from the snapshot, stale packed bytes masked).
    A snapshot that aliased the live ring would fail here."""
    _check_truncate_roundtrip("int4-srft", paged_, [5], [1], 4, 4, seed=11)


@pytest.mark.parametrize("seed", range(6))
def test_random_truncate_roundtrip(seed):
    """The reference's property test (lengths and kept widths drawn at
    random around flush boundaries), as seeded draws: both policies,
    dense and paged."""
    rng = np.random.default_rng(100 + seed)
    W = int(rng.choice([4, 8]))
    k_spec = int(rng.integers(1, W + 1))
    B = int(rng.integers(1, 4))
    L0s = [int(x) for x in rng.integers(0, 2 * W + 1, B)]
    ms = [int(x) for x in rng.integers(0, k_spec + 1, B)]
    for policy in POLICIES:
        for paged_ in (False, True):
            _check_truncate_roundtrip(policy, paged_, L0s, ms, k_spec, W,
                                      seed)


def test_snapshot_copies_into_caller_buffers():
    """A snapshot is a copy (into ``into`` when given, at its addresses):
    appends after it leave it as it was."""
    pol = get_policy("int4-srft", group=8, window=4)
    state = _seeded_state(pol, False, [3, 6], 4, seed=3)
    snap = pol.snapshot_rows(state)
    live = pol.rollback_leaves(state)
    assert all(s.data_ptr() != t.data_ptr() for s, t in zip(snap, live))
    again = pol.snapshot_rows(state, into=snap)
    assert all(a is s for a, s in zip(again, snap))
    kept = [s.clone() for s in snap]
    pol.update(state, torch.ones(2, H, 1, D), torch.ones(2, H, 1, D))
    assert all(torch.equal(a, b) for a, b in zip(snap, kept))
    bf = get_policy("bf16")
    bstate = _seeded_state(bf, False, [3, 6], 4, seed=3)
    bsnap = bf.snapshot_rows(bstate)
    bf.update(bstate, torch.ones(2, H, 1, D), torch.ones(2, H, 1, D))
    assert bsnap.tolist() == [3, 6]


# ----------------------------------------------------- paged tail pages

def _jpaged_like(td) -> "jpaged.PagedData":
    """A reference PagedData holding the port's table, refcounts and
    lengths (``truncate_pages`` reads nothing else)."""
    jd = jpaged.init_paged(td.length.shape[0], td.s_max,
                           page_size=td.page_size, n_pages=td.n_pages,
                           leaf_specs=((1, 1, jnp.float32),))
    return jd._replace(page_table=_j(td.table_host),
                       pool=jpaged.PagePool(_j(td.pool.refcount)),
                       length=_j(td.length))


@pytest.mark.parametrize("policy", POLICIES)
def test_truncate_pages_tail_page_fork_equals_reference(policy):
    """Row 1 adopts row 0's first page (refcount 2, the shape prefix
    reuse makes); truncating row 0 from 12 tokens to 5 releases exactly
    its vacated tail page, keeps the shared one, and gives the
    reference's tables, refcounts and lengths; the sibling reads as
    before."""
    W = 4
    pol = get_policy(policy, group=8, window=W)
    state = _seeded_state(pol, True, [12, 12], W, seed=5)
    pd = state.data.kv if policy == "int4-srft" else state.data
    tab, rc = pd.table_host, pd.pool.refcount
    shared, old = int(tab[0, 0]), int(tab[1, 0])
    rc[shared] += 1
    rc[old] -= 1
    tab[1, 0] = shared
    pd.upload_table()
    q = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, HQ, 1, D)).astype(np.float32))
    before = pol.attend(q, state, backend=AttendBackend.GATHER)
    rc0, tail = rc.clone(), int(tab[0, 2])

    jd = jpaged.truncate_pages(_jpaged_like(pd), jnp.asarray([5, 12]))
    paged.truncate_pages(pd, torch.tensor([5, 12]))
    np.testing.assert_array_equal(pd.table_host.numpy(),
                                  np.asarray(jd.page_table))
    assert torch.equal(pd.page_table, pd.table_host)
    np.testing.assert_array_equal(pd.pool.refcount.numpy(),
                                  np.asarray(jd.pool.refcount))
    np.testing.assert_array_equal(pd.length.numpy(), np.asarray(jd.length))
    assert int(pd.table_host[0, 2]) == paged.NULL_PAGE
    assert int(pd.table_host[0, 0]) == shared
    assert int(pd.pool.refcount[shared]) == 2
    assert int(pd.pool.refcount[tail]) == int(rc0[tail]) - 1
    after = pol.attend(q, state, backend=AttendBackend.GATHER)
    assert torch.equal(after[1], before[1])


# ----------------------------------------------------------- verify reads

def _verify_case(policy, layout, seed=4, k=4, W=16):
    """A state at per-row lengths L0 (one row about to cross a flush),
    its snapshot, k appends and the k queries; plus the sequential
    oracle: k (append, GATHER read) steps from the same entry state."""
    pol = get_policy(policy, group=8, window=W)
    L0s = [13, 30] if layout != "shared" else [13, 13]
    if layout == "shared":
        g = torch.Generator().manual_seed(seed)
        state = pol.init_state(2, H, S_MAX, D, generator=g, device="cpu")
        rng = np.random.default_rng(seed)
        kv = [torch.from_numpy(rng.standard_normal((2, H, 13, D)).astype(
            np.float32)) for _ in "kv"]
        pol.prefill(state, *kv)
        twin = pol.init_state(2, H, S_MAX, D, generator=torch.Generator()
                              .manual_seed(seed), device="cpu")
        pol.prefill(twin, *kv)
    else:
        state = _seeded_state(pol, layout == "paged", L0s, W, seed, S_MAX)
        twin = _seeded_state(pol, layout == "paged", L0s, W, seed, S_MAX)
    rng = np.random.default_rng(seed + 1)
    ks, vs = (torch.from_numpy(rng.standard_normal((2, H, k, D)).astype(
        np.float32)) for _ in "kv")
    q = torch.from_numpy(rng.standard_normal((2, HQ, k, D)).astype(
        np.float32))
    snap = pol.snapshot_rows(state)
    for j in range(k):
        pol.update(state, ks[:, :, j:j + 1], vs[:, :, j:j + 1])
    seq = []
    for j in range(k):
        pol.update(twin, ks[:, :, j:j + 1], vs[:, :, j:j + 1])
        seq.append(pol.attend(q[:, :, j:j + 1], twin,
                              backend=AttendBackend.GATHER))
    return pol, state, snap, q, torch.cat(seq, dim=2)


@pytest.mark.parametrize("layout", ["shared", "ragged", "paged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_verify_query_equals_single_query_read(policy, layout):
    """Each verify query equals the port's single-query GATHER read of
    the historical state bit for bit (so greedy spec == plain), dense
    with a shared or per-row length and paged; KERNEL and BLOCKWISE
    verify the same way."""
    pol, state, snap, q, seq = _verify_case(policy, layout)
    got = pol.verify_attend(q, state, snap)
    assert torch.equal(got, seq)
    blk = pol.verify_attend(q, state, snap, backend="blockwise")
    assert torch.equal(blk, seq)


@pytest.mark.parametrize("policy", POLICIES)
def test_verify_reads_match_reference(policy):
    """The same final cache bytes, snapshot and queries (rotations
    bridged): within VERIFY_ATOL of the reference's verify reads."""
    pol, state, snap, q, _ = _verify_case(policy, "ragged")
    if policy == "int4-srft":
        kv, d = state.data.kv, state.data
        jrot = [JRotation(_j(r.matrix), _j(r.lam), _j(r.signs), r.kind)
                for r in (d.rot_k, d.rot_v)]
        jc = jkvcache.QuantKVCache(*(_j(getattr(kv, f)) for f in
                                     jkvcache.QuantKVCache._fields))
        want = jqar.verify_attention_quant(
            _j(q), jc, *jrot, snap_k_res=_j(snap[0]), snap_v_res=_j(snap[1]),
            base_len=_j(snap[2]))
        got = verify_attention_quant(q, kv, d.rot_k, d.rot_v,
                                     snap_k_res=snap[0], snap_v_res=snap[1],
                                     base_len=snap[2])
    else:
        d = state.data
        jc = jkvcache.BF16KVCache(_j(d.k.float()).astype(jnp.bfloat16),
                                  _j(d.v.float()).astype(jnp.bfloat16),
                                  _j(d.length))
        want = jqar.verify_attention_bf16(_j(q), jc, base_len=_j(snap))
        got = verify_attention_bf16(q, d, base_len=snap)
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= VERIFY_ATOL, err


def test_kernel_verify_warns_once_and_never_calls_b1_b2(monkeypatch):
    """An int4 KERNEL verify warns once (the B1/B2 kernels are
    single-query), reads with GATHER's numerics and calls neither
    kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("a verify pass called a B1/B2 wrapper")

    monkeypatch.setattr(quant_attention, "decode_attention_kernel", refuse)
    monkeypatch.setattr(quant_attention, "decode_attention_kernel_paged",
                        refuse)
    monkeypatch.setattr(cache_api, "_KERNEL_VERIFY_WARNED", False)
    pol, state, snap, q, seq = _verify_case("int4-srft", "ragged")
    with pytest.warns(RuntimeWarning, match="multi-query"):
        got = pol.verify_attend(q, state, snap, backend="kernel")
    assert torch.equal(got, seq)
    pol, state, snap, q, seq = _verify_case("int4-srft", "paged")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once per process
        got = pol.verify_attend(q, state, snap, backend="kernel")
    assert torch.equal(got, seq)


# ---------------------------------------------------------- model level

@pytest.mark.parametrize("ragged", [False, True], ids=["plain", "ragged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_decode_verify_logits_equal_sequential_steps(lm, policy, ragged):
    """Under bf16 operands, ``LM.decode_verify``'s logits for token j are
    the sequential ``decode_step``'s bit for bit, and after
    ``truncate_cache`` to L0 + 2 the cache decodes on as the sequential
    one that appended two tokens."""
    _, _, model, params, toks = lm
    prompt = _t(toks).long()
    block = torch.tensor([[5, 9, 5, 9]])
    with common.dot_mode(True):
        a = model.init_cache(1, S_MAX, policy=policy, ragged=ragged)
        b = model.init_cache(1, S_MAX, policy=policy, ragged=ragged)
        model.prefill(params, prompt, a)
        model.prefill(params, prompt, b)
        lv, a, snaps = model.decode_verify(params, block, a)
        seq = [model.decode_step(params, block[:, j:j + 1], b)[0]
               for j in range(2)]
        assert torch.equal(lv[:, :2], torch.cat(seq, dim=1))
        L0 = 23 if not ragged else torch.tensor([23], dtype=torch.int32)
        model.truncate_cache(a, L0 + 2, snaps)
        assert int(a["pos"] if not ragged else a["pos"][0]) == 25
        nxt = torch.tensor([[7]])
        la, _ = model.decode_step(params, nxt, a)
        lb, _ = model.decode_step(params, nxt, b)
        assert torch.equal(la, lb)


@pytest.mark.parametrize("ragged", [False, True], ids=["plain", "ragged"])
@pytest.mark.parametrize("k", [2, 4, 16])
@pytest.mark.parametrize("policy", POLICIES)
def test_engine_generate_spec_equals_generate(lm, policy, k, ragged):
    """generate_spec == generate token for token, for each policy and k
    (16 = W: one full ring wrap a pass), on a plain cache (the accepted
    count read once a pass) and a ragged one (the graph's schedule, run
    eagerly); accepted <= drafted."""
    _, _, model, params, toks = lm
    prompt = _t(toks).long()
    eng = Engine(model)
    ref, _ = eng.generate(params, prompt, model.init_cache(
        1, S_MAX, policy=policy, ragged=ragged), NEW)
    cache = model.init_cache(1, S_MAX, policy=policy, ragged=ragged)
    out, cache, stats = eng.generate_spec(params, prompt, cache, NEW,
                                          spec_k=k)
    assert torch.equal(out, ref)
    assert 0 <= stats["accepted"] <= stats["drafted"]
    assert int(cache["pos"] if not ragged else cache["pos"][0]) \
        == toks.shape[1] + NEW - 1


def _raised(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_engine_spec_validation_matches_reference(lm):
    """Each refusal of the reference, with its message, before the
    prefill touches the cache."""
    jm, jp, model, params, toks = lm
    W = get_policy("int4-srft").window
    jc = jm.init_cache(1, S_MAX, policy="int4-srft", key=jax.random.PRNGKey(7))
    jc2 = jm.init_cache(2, S_MAX, policy="int4-srft",
                        key=jax.random.PRNGKey(7))
    tc = model.init_cache(1, S_MAX, policy="int4-srft")
    tc2 = model.init_cache(2, S_MAX, policy="int4-srft")
    jt, tt = jnp.asarray(toks), _t(toks).long()
    cases = [
        (lambda: JEngine(jm, donate=False).generate_spec(
            jp, jt, jc, 8, spec_k=1),
         lambda: Engine(model).generate_spec(params, tt, tc, 8, spec_k=1)),
        (lambda: JEngine(jm, donate=False).generate_spec(
            jp, jt, jc, 8, spec_k=W + 1),
         lambda: Engine(model).generate_spec(params, tt, tc, 8,
                                             spec_k=W + 1)),
        (lambda: JEngine(jm, sampler=JSampler(temperature=0.7),
                         donate=False).generate_spec(jp, jt, jc, 8, spec_k=4),
         lambda: Engine(model, sampler=Sampler(temperature=0.7))
         .generate_spec(params, tt, tc, 8, spec_k=4)),
        (lambda: JEngine(jm, donate=False).generate_spec(
            jp, jnp.tile(jt, (2, 1)), jc2, 8, spec_k=4),
         lambda: Engine(model).generate_spec(params, tt.repeat(2, 1), tc2, 8,
                                             spec_k=4)),
    ]
    for ref, port in cases:
        assert _raised(port) == _raised(ref)
    assert tc["pos"] == 0  # nothing was prefilled
    with pytest.raises(ValueError, match="spec_k-1"):
        Engine(model).generate_spec(params, tt, tc, S_MAX - 23 + 1, spec_k=4)


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_spec_stream_matches_reference(lm, policy):
    """The port's speculative stream against the reference's: equal up
    to a near-tie of the port's own logits; where equal, the drafted and
    accepted counts are too."""
    jm, jp, model, params, toks = lm
    jc = jm.init_cache(1, S_MAX, policy=policy, key=jax.random.PRNGKey(7))
    rots = None
    if policy == "int4-srft":
        d = jc["attn"].data
        rots = bridge.rotations({
            side: {f: np.asarray(getattr(getattr(d, f"rot_{side}"), f))
                   for f in ("matrix", "lam", "signs")}
            for side in ("k", "v")})
    want, _, jstats = JEngine(jm, donate=False).generate_spec(
        jp, jnp.asarray(toks), jc, NEW, spec_k=4)
    want = np.asarray(want)
    prompt = _t(toks).long()
    eng = Engine(model)
    got, _, stats = eng.generate_spec(
        params, prompt, model.init_cache(1, S_MAX, policy=policy, rots=rots),
        NEW, spec_k=4)
    _, logits, _ = eng.generate(params, prompt, model.init_cache(
        1, S_MAX, policy=policy, rots=rots), NEW, return_logits=True)
    got = got.numpy()
    diff = np.nonzero(got[0] != want[0])[0]
    if diff.size:
        i = int(diff[0])
        top2 = logits[0, i].topk(2).values
        gap = float(top2[0] - top2[1])
        assert gap < LOGIT_TOL * float(logits.abs().max()), (i, gap)
    else:
        assert {k: stats[k] for k in jstats} == \
            {k: int(v) for k, v in jstats.items()}


# ------------------------------------------------------------ batch engine

def _mixed_requests(vocab):
    rng = np.random.RandomState(3)
    base = rng.randint(0, vocab, size=(7,))
    reqs = []
    for rid, (plen, new) in enumerate([(14, 9), (21, 15), (7, 5)]):
        prompt = np.tile(base, 6)[:plen].astype(np.int32)
        prompt[0] = rid
        reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=new))
    return reqs


def _run_batch(lm, policy, paged_, spec_k, eos=None, **kw):
    _, _, model, params, _ = lm
    eng = BatchEngine(model, params, capacity=2, s_max=S_MAX, policy=policy,
                      chunk=4, paged=paged_, page_size=16, spec_k=spec_k,
                      eos_id=eos, device="cpu", **kw)
    out = {c.rid: (c.tokens.tolist(), c.finish_reason)
           for c in eng.run(_mixed_requests(model.cfg.vocab_size))}
    return out, eng


@pytest.mark.parametrize("paged_", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("policy", POLICIES)
def test_batch_spec_equals_plain(lm, policy, paged_):
    """Every row's stream and finish reason equal the plain engine's, with
    slot reuse and per-row acceptance widths; no page leaks; the counters
    are consistent."""
    ref, _ = _run_batch(lm, policy, paged_, None)
    got, eng = _run_batch(lm, policy, paged_, 4)
    assert got == ref
    assert 0 <= eng.n_accepted <= eng.n_drafted
    assert eng.n_rejected == eng.n_drafted - eng.n_accepted
    if paged_:
        assert eng.pool_stats()["pages_used"] == 0


def test_batch_spec_eos_inside_accepted_block(lm):
    """An EOS inside a kept block ends the stream where the sequential
    run stopped: the same tokens and reason."""
    plain, _ = _run_batch(lm, "int4-srft", False, None)
    eos = plain[1][0][len(plain[1][0]) // 2]
    ref, _ = _run_batch(lm, "int4-srft", False, None, eos=eos)
    got, _ = _run_batch(lm, "int4-srft", False, 4, eos=eos)
    assert got == ref
    assert any(r == "eos" for _, r in got.values())


def test_batch_spec_preemption_and_chunked_admission(lm):
    """A pool of one row's pages (LRU preemption, the continuation's
    history reseeded from its absorbed prompt) and chunked admission
    (the history seeded by the shared bookkeeping) both give the plain
    engine's streams under spec_k=4, and every page comes back."""
    ref, _ = _run_batch(lm, "int4-srft", True, None, n_pages=5)
    got, eng = _run_batch(lm, "int4-srft", True, 4, n_pages=5)
    assert eng.n_preemptions > 0 and got == ref
    assert eng.pool_stats()["pages_used"] == 0
    for policy in POLICIES:
        ref, _ = _run_batch(lm, policy, True, None)
        got, eng = _run_batch(lm, policy, True, 4, prefill_chunk=16)
        assert got == ref and eng.n_prefill_chunks > 0


def test_batch_spec_validation_matches_reference(lm):
    """The reference's refusals and messages, the spec_k - 1 slack in
    ``submit`` and in the page plan, and what is still not ported."""
    jm, jp, model, params, _ = lm
    W = get_policy("int4-srft").window
    cases = [dict(spec_k=4, sampler=("temperature", 0.5)), dict(spec_k=1),
             dict(spec_k=W + 1, policy="int4-srft")]
    for kw in cases:
        smp = kw.pop("sampler", None)
        jkw, tkw = dict(kw), dict(kw)
        if smp:
            jkw["sampler"] = JSampler(temperature=smp[1])
            tkw["sampler"] = Sampler(temperature=smp[1])
        want = _raised(lambda: JBatchEngine(jm, jp, capacity=2, s_max=64,
                                            **jkw))
        assert _raised(lambda: BatchEngine(model, params, capacity=2,
                                           s_max=64, device="cpu",
                                           **tkw)) == want
    req = dict(rid=0, prompt=np.zeros((16,), np.int32), max_new_tokens=16)
    jeng = JBatchEngine(jm, jp, capacity=2, s_max=32, spec_k=4)
    eng = BatchEngine(model, params, capacity=2, s_max=32, spec_k=4,
                      device="cpu")
    want = _raised(lambda: jeng.submit(JRequest(**req)))
    assert "spec_k-1" in want
    assert _raised(lambda: eng.submit(Request(**req))) == want
    eng = BatchEngine(model, params, capacity=1, s_max=64, spec_k=4,
                      paged=True, page_size=16, device="cpu")
    assert eng._pages_needed(30, 2) == 3  # 32 tokens + 3 of slack
    assert eng.n_rejected == 0
    # the host prefix tier (A6) takes a speculative engine, as the
    # reference's does
    eng = BatchEngine(model, params, capacity=1, s_max=64, spec_k=4,
                      paged=True, page_size=16, prefill_chunk=16,
                      offload_bytes=1 << 20, device="cpu")
    assert eng.prefix_store is not None and eng.n_spilled_pages == 0
