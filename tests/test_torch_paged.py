"""Port parity for the ragged and paged cache (``repro_torch.core.kvcache``
ragged paths, ``repro_torch.core.paged``) and for kernel B2's plain version
and wrapper, against ``repro.core`` and the reference's paged Pallas kernel
in interpret mode, on the CPU.  Inputs are made with numpy from a seed.

Tolerances: allocator page ids, refcounts, page tables and lengths are
integers and must be equal; bf16 cache bytes are copied, so equal; int4
codes equal except a +-1 flip where the rotated value over its scale lies
within TIE_BAND of a .5 boundary (the two frameworks sum the rotation in
different orders), scales within rtol 1e-6, the fp32 residual windows
within atol 1e-5 (rotation sums); attention outputs within atol 2e-5
(fp32 softmax sums in another order; outputs are O(1))."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kvcache as jkv  # noqa: E402
from repro.core import paged as jpaged  # noqa: E402
from repro.core.cache_api import get_policy as jget_policy  # noqa: E402
from repro.core.quant_attention_ref import (  # noqa: E402
    decode_attention_quant as jdecode_quant,
)
from repro.kernels.quant_attention.ops import (  # noqa: E402
    decode_attention_kernel_paged as jdecode_paged,
)
from repro.kernels.quant_attention.quant_attention import (  # noqa: E402
    quant_decode_attention_paged_fwd,
)
from repro_torch import bridge  # noqa: E402
from repro_torch.core import kvcache, packing, paged  # noqa: E402
from repro_torch.core.cache_api import get_policy  # noqa: E402
from repro_torch.core.quant_attention_ref import (  # noqa: E402
    decode_attention_quant,
)
from repro_torch.core.transforms import Rotation  # noqa: E402
from repro_torch.kernels.quant_attention import ops as qa_ops  # noqa: E402
from repro_torch.kernels.quant_attention import ref as qa_ref  # noqa: E402

TIE_BAND = 1e-4
MAX_FLIP_SHARE = 1e-3
B, H, D, W, PS, S_MAX, GROUP = 3, 2, 64, 16, 16, 64, 32
N_PAGES = 14
KEY = jax.random.PRNGKey(3)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The ops here are tiny: intra-op threads only add contention between
    test workers.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return np.asarray(x)


def _bits(x):
    """numpy view of a cache leaf; bf16 as its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ----------------------------------------------------------------- allocator

@pytest.mark.parametrize("seed", range(4))
def test_allocator_choices_equal_reference(seed):
    """Seeded alloc / incref / free schedules: every allocation returns
    the reference's page ids and every refcount equals its refcount."""
    rng = np.random.default_rng(seed)
    n_pages, max_pages = 20, 6
    jp, tp = jpaged.pool_init(n_pages), paged.pool_init(n_pages)
    held: list[int] = []
    for _ in range(40):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(0, max_pages + 1))
            jp, jpages = jpaged.pool_alloc(jp, jnp.asarray(n), max_pages)
            tp, tpages = paged.pool_alloc(tp, n, max_pages)
            np.testing.assert_array_equal(tpages.numpy(), _n(jpages))
            held += [int(p) for p in tpages if p != paged.NULL_PAGE]
        elif op == 1 and held:
            pick = rng.choice(held, size=min(3, len(held)), replace=True)
            jp = jpaged.pool_incref(jp, jnp.asarray(pick, jnp.int32))
            tp = paged.pool_incref(tp, pick)
            held += [int(p) for p in pick]
        elif held:
            k = int(rng.integers(1, min(4, len(held)) + 1))
            pick = [held.pop(int(rng.integers(0, len(held))))
                    for _ in range(k)]
            valid = rng.random(len(pick)) < 0.8
            jp = jpaged.pool_free(jp, jnp.asarray(pick, jnp.int32),
                                  jnp.asarray(valid))
            tp = paged.pool_free(tp, pick, valid)
            held += [p for p, v in zip(pick, valid) if not v]
        np.testing.assert_array_equal(tp.refcount.numpy(), _n(jp.refcount))
        assert paged.pool_n_free(tp) == int(jpaged.pool_n_free(jp))
        assert paged.pool_used(tp) == int(jpaged.pool_used(jp))


def test_allocator_double_free_clamps_and_null_stays_pinned():
    tp = paged.pool_init(5)
    tp, pages = paged.pool_alloc(tp, 2, 4)
    assert pages.tolist() == [1, 2, 0, 0]
    tp = paged.pool_free(paged.pool_free(tp, [1, 0]), [1])
    assert tp.refcount.tolist() == [1, 0, 1, 0, 0]
    with pytest.raises(ValueError):
        paged.pool_init(1)


# ----------------------------------------------------------------- helpers

def _rot_pair(jstate):
    d = jstate.data

    def one(r):
        return Rotation(_t(r.matrix), _t(r.lam), _t(r.signs), r.kind)

    return one(d.rot_k), one(d.rot_v)


def _assert_codes(got, ref, y_exact, scales):
    """int4 codes equal except +-1 flips at .5 ties of y/scale."""
    cg = packing.unpack_int4(_t(got)).numpy().astype(np.int32)
    cr = packing.unpack_int4(_t(ref)).numpy().astype(np.int32)
    diff = cg - cr
    if not diff.size:
        return
    assert np.abs(diff).max() <= 1
    ratio = y_exact / np.repeat(np.asarray(scales, np.float64), GROUP, -1)
    near_tie = np.abs(np.abs(ratio) % 1.0 - 0.5) < TIE_BAND
    assert not np.any((diff != 0) & ~near_tie), "a code flipped off a tie"
    assert (diff != 0).mean() <= MAX_FLIP_SHARE


class _Pair:
    """The same int4 or bf16 cache built in both packages: a paged state
    (or a ragged dense one) and per-row histories of the raw K/V each
    valid position holds."""

    def __init__(self, policy, paged_state):
        self.int4 = policy == "int4-srft"
        self.jpol = jget_policy(policy, group=GROUP, window=W)
        self.pol = get_policy(policy, group=GROUP, window=W)
        if paged_state:
            self.js = self.jpol.init_paged(B, H, S_MAX, D, n_pages=N_PAGES,
                                           page_size=PS, key=KEY)
            self.ts = self.pol.init_paged(B, H, S_MAX, D, n_pages=N_PAGES,
                                          page_size=PS, device="cpu")
        else:
            self.js = self.jpol.init_state(B, H, S_MAX, D, key=KEY,
                                           ragged=True)
            self.ts = self.pol.init_state(B, H, S_MAX, D, device="cpu",
                                          ragged=True)
        self._jupdate = jax.jit(
            lambda s, k, v, a: self.jpol.update(s, k, v, active=a))
        self.rots = _rot_pair(self.js) if self.int4 else None
        if self.rots:
            self.ts = self.pol.with_rotations(self.ts, *self.rots)
        self.hist = [[None, None] for _ in range(B)]

    def row(self, k, v):
        """(jax row, port row): batch-1 ragged caches prefilled with k, v."""
        jr = self.jpol.init_state(1, H, S_MAX, D, key=KEY, ragged=True)
        jr = self.jpol.prefill(jr, jnp.asarray(k), jnp.asarray(v))
        tr = self.pol.init_state(1, H, S_MAX, D, device="cpu", ragged=True)
        if self.rots:
            tr = self.pol.with_rotations(tr, *self.rots)
        return jr, self.pol.prefill(tr, _t(k), _t(v))

    def admit_paged(self, slot, k, v, shared, n_new):
        jr, tr = self.row(k, v)
        sp = np.full((S_MAX // PS,), paged.NULL_PAGE, np.int32)
        sp[:len(shared)] = shared
        self.js = self.jpol.insert_row_paged(
            self.js, jr, jnp.asarray(slot), jnp.asarray(sp),
            jnp.asarray(len(shared)), jnp.asarray(n_new))
        self.pol.insert_row_paged(self.ts, tr, slot, shared, len(shared),
                                  n_new)
        self.hist[slot] = [k[0], v[0]]

    def admit_dense(self, slot, k, v):
        jr, tr = self.row(k, v)
        self.js = self.jpol.insert_row(self.js, jr, jnp.asarray(slot))
        self.pol.insert_row(self.ts, tr, slot)
        self.hist[slot] = [k[0], v[0]]

    def update(self, k, v, active):
        self.js = self._jupdate(self.js, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(active))
        self.pol.update(self.ts, _t(k), _t(v), active=_t(active))
        for b in np.nonzero(active)[0]:
            for i, x in enumerate((k, v)):
                self.hist[b][i] = np.concatenate([self.hist[b][i], x[b]], 1)

    def reset(self, mask):
        self.js = self.jpol.reset_rows(self.js, jnp.asarray(mask))
        self.pol.reset_rows(self.ts, mask)
        for b in np.nonzero(mask)[0]:
            self.hist[b] = [None, None]

    def check(self):
        """Tables, lengths, refcounts exactly; every valid cached position
        per the module tolerances."""
        jd = self.js.data.kv if self.int4 else self.js.data
        td = self.ts.data.kv if self.int4 else self.ts.data
        L = td.length.numpy()
        np.testing.assert_array_equal(L, _n(jd.length))
        if self.ts.is_paged:
            np.testing.assert_array_equal(td.table_host.numpy(),
                                          _n(jd.page_table))
            np.testing.assert_array_equal(td.page_table.numpy(),
                                          _n(jd.page_table))
            np.testing.assert_array_equal(td.pool.refcount.numpy(),
                                          _n(jd.pool.refcount))
            tv = [_bits(x) for x in paged.gather_view(td)]
            jv = [_bits(x) for x in jpaged.gather_view(jd)]
            t_res = [x.numpy() for x in td.residual]
            j_res = [_n(x) for x in jd.residual]
        else:
            names = (("k_packed", "k_scales", "v_packed", "v_scales")
                     if self.int4 else ("k", "v"))
            tv = [_bits(getattr(td, f)) for f in names]
            jv = [_bits(getattr(jd, f)) for f in names]
            t_res = [td.k_residual.numpy(), td.v_residual.numpy()] \
                if self.int4 else []
            j_res = [_n(jd.k_residual), _n(jd.v_residual)] \
                if self.int4 else []
        for b in range(B):
            if self.hist[b][0] is None:
                continue
            if not self.int4:
                for t, j in zip(tv, jv):
                    np.testing.assert_array_equal(t[b][:, :L[b]],
                                                  j[b][:, :L[b]])
                continue
            plen = L[b] - L[b] % W
            for side, (rot, raw) in enumerate(zip(self.rots,
                                                  self.hist[b])):
                pk, sc = 2 * side, 2 * side + 1
                np.testing.assert_allclose(tv[sc][b][:, :plen],
                                           jv[sc][b][:, :plen], rtol=1e-6)
                y = (raw[:, :plen].astype(np.float64)
                     @ rot.matrix.double().numpy().T) * rot.lam.numpy()
                _assert_codes(tv[pk][b][:, :plen], jv[pk][b][:, :plen], y,
                              jv[sc][b][:, :plen])
                n_res = L[b] - plen
                np.testing.assert_allclose(t_res[side][b][:, :n_res],
                                           j_res[side][b][:, :n_res],
                                           atol=1e-5)


def _kv(rng, n, rows=1):
    return (rng.standard_normal((rows, H, n, D)).astype(np.float32),
            rng.standard_normal((rows, H, n, D)).astype(np.float32))


def _bf16_exact(x):
    """Round through bf16 so both packages store the same bytes."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# ------------------------------------------------------------ ragged dense

@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_ragged_dense_updates_match_reference(policy):
    """``insert_row`` + ``decode_update_ragged`` / the bf16 ragged append
    with an ``active`` mask, then ``reset_rows``: rows at 22, 37 and 15
    (W-1) tokens cross W-flushes at their own steps."""
    rng = np.random.default_rng(5)
    pair = _Pair(policy, paged_state=False)
    fix = _bf16_exact if policy == "bf16" else (lambda x: x)
    for slot, n in enumerate((22, 37, 15)):
        pair.admit_dense(slot, *(fix(x) for x in _kv(rng, n)))
    pair.check()
    for step in range(20):
        active = np.array([True, step % 3 != 1, step < 12])
        pair.update(*(fix(x) for x in _kv(rng, 1, B)), active)
    pair.check()
    pair.reset(np.array([False, True, False]))
    assert pair.ts.lengths.tolist() == [42, 0, 27]
    pair.check()


# ------------------------------------------------------------------ paged

@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_paged_writes_match_reference(policy):
    """``insert_row`` (fresh pages, then a COW sharer of two prefix
    pages), ``append_token`` / ``int4_update_paged`` (which calls
    ``write_slab``) under an ``active`` mask, ``reset_rows``, and a
    re-admission onto non-contiguous freed pages: the same tables,
    refcounts, lengths, residual windows and cached bytes as the
    reference (its scratch page 0 is never compared: it only holds
    masked writes)."""
    rng = np.random.default_rng(7)
    pair = _Pair(policy, paged_state=True)
    fix = _bf16_exact if policy == "bf16" else (lambda x: x)
    k0, v0 = (fix(x) for x in _kv(rng, 22))
    pair.admit_paged(0, k0, v0, [], 3)
    k1, v1 = (fix(x) for x in _kv(rng, 37))
    pair.admit_paged(1, k1, v1, [], 4)
    # a sharer: the same first 32 tokens, so the same two full pages
    tail_k, tail_v = (fix(x) for x in _kv(rng, 1))
    k2 = np.concatenate([k1[:, :, :32], tail_k], 2)
    v2 = np.concatenate([v1[:, :, :32], tail_v], 2)
    shared = pair.ts.data.kv.table_host[1, :2].tolist() if pair.int4 \
        else pair.ts.data.table_host[1, :2].tolist()
    pair.admit_paged(2, k2, v2, shared, 2)
    pair.check()
    for step in range(24):
        active = np.array([step < 20, True, step % 4 != 2])
        pair.update(*(fix(x) for x in _kv(rng, 1, B)), active)
    pair.check()
    pair.reset(np.array([True, False, False]))
    pair.check()
    kn, vn = (fix(x) for x in _kv(rng, W - 1))
    pair.admit_paged(0, kn, vn, [], 4)
    td = pair.ts.data.kv if pair.int4 else pair.ts.data
    row0 = td.table_host[0].tolist()
    assert row0 != list(range(row0[0], row0[0] + 4)), row0
    for step in range(5):  # row 1 is full (61 of 64 with 4 pages)
        pair.update(*(fix(x) for x in _kv(rng, 1, B)),
                    np.array([True, False, True]))
    pair.check()


def test_gather_view_equals_reference():
    """On the same pools and a shuffled table with an all-null row, the
    gathered per-row view equals the reference's everywhere."""
    rng = np.random.default_rng(11)
    MP, n_pages = 4, 9
    pools = (rng.integers(0, 256, (n_pages, H, PS, D // 2)).astype(np.uint8),
             rng.standard_normal((n_pages, H, PS, D // GROUP)).astype(
                 np.float32))
    table = np.array([[3, 7, 1, 0], [0, 0, 0, 0], [8, 2, 5, 6]], np.int32)
    jd = jpaged.init_paged(B, MP * PS, page_size=PS, n_pages=n_pages,
                           leaf_specs=((H, D // 2, jnp.uint8),
                                       (H, D // GROUP, jnp.float32)))
    jd = jd._replace(pools=tuple(jnp.asarray(p) for p in pools),
                     page_table=jnp.asarray(table))
    td = paged.init_paged(B, MP * PS, page_size=PS, n_pages=n_pages,
                          leaf_specs=((H, D // 2, torch.uint8),
                                      (H, D // GROUP, torch.float32)))
    td.pools = tuple(_t(p) for p in pools)
    td.table_host.copy_(_t(table))
    td.upload_table()
    for t, j in zip(paged.gather_view(td), jpaged.gather_view(jd)):
        np.testing.assert_array_equal(t.numpy(), _n(j))
    dense = paged.pages_to_dense(td.pools[0][_t(table[0]).long()])
    np.testing.assert_array_equal(dense.numpy(),
                                  _n(jpaged.pages_to_dense(
                                      jnp.asarray(pools[0][table[0]]))))


def test_init_paged_validates_shapes():
    with pytest.raises(ValueError, match="multiple of page_size"):
        paged.init_paged(1, 40, page_size=16, n_pages=4, leaf_specs=())
    with pytest.raises(ValueError, match="flush window"):
        get_policy("int4-srft", window=16).init_paged(
            1, 1, 64, 64, n_pages=5, page_size=8, device="cpu")


def test_paged_nbytes_counts_metadata():
    """``persistent_only=False`` adds exactly the page table + refcounts
    (+ the int4 residual windows), as the reference accounts them."""
    for name in ("bf16", "int4-srft"):
        pol = get_policy(name, group=GROUP, window=W)
        st = pol.init_paged(2, H, S_MAX, D, n_pages=9, page_size=PS,
                            device="cpu")
        jst = jget_policy(name, group=GROUP, window=W).init_paged(
            2, H, S_MAX, D, n_pages=9, page_size=PS, key=KEY)
        assert st.nbytes() == jst.nbytes()
        assert st.nbytes(persistent_only=False) == \
            jst.nbytes(persistent_only=False)
        assert pol.compression_ratio(st) == pytest.approx(
            jst.policy.compression_ratio(jst))


# ------------------------------------------------------ B2 and the reads

def _paged_inputs(seed, lengths, G, d, group, ps=PS, s_max=S_MAX):
    """Random pools of ``ps``-token pages, per-row windows, a shuffled page
    table (unmapped entries at the null page) and per-(b, h) lengths;
    ``s_max`` is a multiple of ``ps``."""
    rng = np.random.default_rng(seed)
    Bn, MP = len(lengths), s_max // ps
    need = [-(-L // ps) for L in lengths]
    n_pages = sum(need) + 3
    perm = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((Bn, MP), np.int32)
    for b, n in enumerate(need):
        table[b, :n] = [perm.pop() for _ in range(n)]
    N = n_pages * H
    inp = dict(
        q_eff=rng.standard_normal((Bn * H, G, d)).astype(np.float32) * 0.3,
        k_packed=rng.integers(0, 256, (N, ps, d // 2)).astype(np.uint8),
        k_scales=rng.uniform(0.05, 0.5, (N, ps, d // group)).astype(
            np.float32),
        v_packed=rng.integers(0, 256, (N, ps, d // 2)).astype(np.uint8),
        v_scales=rng.uniform(0.05, 0.5, (N, ps, d // group)).astype(
            np.float32),
        k_residual=rng.standard_normal((Bn * H, W, d)).astype(np.float32),
        v_residual=rng.standard_normal((Bn * H, W, d)).astype(np.float32),
    )
    L = np.repeat(np.asarray(lengths, np.int32), H)
    return inp, L - L % W, L, table


# row lengths: empty (a retired row), W-1 (all residual), a non-multiple of
# W, a full row, a flush boundary
def _b2_lengths(s_max):
    return [0, W - 1, 37, s_max, 48]


# page sizes of 16 and, as the int4 paged policy also serves them, 48 and
# 80: pages that neither divide nor are a multiple of the card kernel's
# 64-token tile, with rows that end inside a page
@pytest.mark.parametrize("d,G,group,ps,s_max", [
    (64, 2, 32, PS, S_MAX), (128, 2, 32, PS, S_MAX), (128, 4, 16, PS, S_MAX),
    (64, 2, 32, 48, 144), (128, 2, 32, 80, 160)])
def test_b2_plain_matches_interpret_kernel(d, G, group, ps, s_max):
    inp, plen, tlen, table = _paged_inputs(d + G, _b2_lengths(s_max), G, d,
                                           group, ps, s_max)
    ref = quant_decode_attention_paged_fwd(
        *(jnp.asarray(v) for v in inp.values()), jnp.asarray(plen),
        jnp.asarray(tlen), jnp.asarray(table), group=group, page_size=ps,
        n_kv_heads=H)
    before = qa_ops.paged_launches
    got = qa_ops.quant_decode_attention_paged(
        *(_t(v) for v in inp.values()), _t(plen), _t(tlen), _t(table),
        group=group, page_size=ps, n_kv_heads=H)
    assert qa_ops.paged_launches == before  # the plain version on the CPU
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), _n(ref), atol=2e-5)
    # the plain version is B1's plain math on the resolved rows
    rows = [qa_ref.paged_rows(_t(inp[k]), _t(table), H)
            for k in ("k_packed", "k_scales", "v_packed", "v_scales")]
    dense = qa_ref.quant_decode_attention_ref(
        _t(inp["q_eff"]), *rows, _t(inp["k_residual"]),
        _t(inp["v_residual"]), _t(plen), _t(tlen), group=group, blk=ps)
    np.testing.assert_array_equal(got.numpy(), dense.numpy())


def _int4_paged_pair(seed, lengths):
    """A paged int4 state built identically in both packages through
    admissions of random prompts (lengths per row; 0 = never admitted),
    on a shuffled pool, plus a few decode steps."""
    rng = np.random.default_rng(seed)
    pair = _Pair("int4-srft", paged_state=True)
    # scramble the free list: admit and retire a row first
    pair.admit_paged(1, *_kv(rng, 20), [], 2)
    pair.reset(np.array([False, True, False]))
    for slot, n in enumerate(lengths):
        if n:
            pair.admit_paged(slot, *_kv(rng, n), [],
                             -(-min(n + 4, S_MAX) // PS))
    active = np.array([n > 0 for n in lengths])
    for _ in range(2):
        pair.update(*_kv(rng, 1, B), active)
    return pair, rng


@pytest.mark.parametrize("lengths", [(0, W - 3, 35), (40, 0, 13)])
def test_paged_attend_matches_reference(lengths):
    """``attend`` on a paged int4 state: KERNEL (B2's plain version through
    ``decode_attention_kernel_paged``) against the reference's paged
    kernel wrapper (interpret mode), GATHER against the reference's GATHER
    on its gathered view, and the port's two reads against each other.
    The row of length 0 gives a finite output."""
    pair, rng = _int4_paged_pair(sum(lengths), lengths)
    pair.check()
    q = rng.standard_normal((B, 2 * H, 1, D)).astype(np.float32)
    jd = pair.js.data
    jrk, jrv = jd.rot_k, jd.rot_v
    ref_k = _n(jdecode_paged(jnp.asarray(q), jd.kv, jrk, jrv))
    jdense = jkv.QuantKVCache(*jpaged.gather_view(jd.kv), *jd.kv.residual,
                              jd.kv.length)
    ref_g = _n(jdecode_quant(jnp.asarray(q), jdense, jrk, jrv))
    got_k = pair.pol.attend(_t(q), pair.ts, backend="kernel").numpy()
    got_g = pair.pol.attend(_t(q), pair.ts, backend="gather").numpy()
    assert np.isfinite(got_k).all() and np.isfinite(got_g).all()
    np.testing.assert_allclose(got_k, ref_k, atol=2e-5)
    np.testing.assert_allclose(got_g, ref_g, atol=2e-5)
    # an empty row's output is a finite garbage mean that differs by read
    live = np.asarray(lengths) > 0
    np.testing.assert_allclose(got_k[live], got_g[live], atol=2e-5)


def test_ragged_gather_read_matches_reference_per_row():
    """The GATHER read with per-row lengths (an empty row, a residual-only
    row, a row at a flush boundary) against the reference's."""
    rng = np.random.default_rng(13)
    pair = _Pair("int4-srft", paged_state=False)
    for slot, n in ((1, 9), (2, 48)):
        pair.admit_dense(slot, *_kv(rng, n))
    q = rng.standard_normal((B, 2 * H, 1, D)).astype(np.float32)
    jd = pair.js.data
    ref = _n(jdecode_quant(jnp.asarray(q), jd.kv, jd.rot_k, jd.rot_v))
    td = pair.ts.data
    got = decode_attention_quant(_t(q), td.kv, td.rot_k, td.rot_v).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    assert kvcache.packed_len(td.kv).tolist() == [0, 0, 48]
