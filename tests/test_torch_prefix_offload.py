"""The host prefix tier (ROADMAP A6): the port's ``PrefixStore``, the
policies' ``export_pages`` / ``import_pages`` and ``BatchEngine(
offload_bytes=, offload_dir=)`` against the reference
(``repro/launch/prefix_store.py``, ``repro/core/cache_api.py:529-547,
:638-647, :897-913, :1251-1265``, ``repro/launch/batch_engine.py``), and
the oracle the reference proves within itself
(``tests/test_prefix_offload.py``) proven within the port.  CPU, smol-d64
cut to 2 layers, S_MAX 64, pages of 16, capacity 3; inputs from numpy
seeds, params carried across by ``repro_torch.bridge``.

Tolerances.  Store statistics are integers and equal the reference's.
Within the port every comparison is bit for bit: a restore places the
exported bytes where ``adopt_prefix`` places the resident ones, and a
restored stream equals the stream of a request that hit the resident
pages.  Across packages exported bf16 and int8 bytes are equal; int4
codes are equal except a +-1 flip where the rotated value over its scale
lies within TIE_BAND of a .5 boundary (the two frameworks sum the
rotation in different orders), scales within rtol 1e-6 (the rule of
``tests/test_torch_paged.py``)."""
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
from repro.launch.prefix_store import PrefixStore as JPrefixStore  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.cache_api import available_policies, get_policy  # noqa: E402
from repro_torch.core.paged import NULL_PAGE  # noqa: E402
from repro_torch.core.transforms import Rotation  # noqa: E402
from repro_torch.launch.batch_engine import BatchEngine, Request  # noqa: E402
from repro_torch.launch.prefix_store import PrefixStore  # noqa: E402

S_MAX, PAGE, CAPACITY = 64, 16, 3
H, D, GROUP = 2, 64, 32
TIE_BAND = 1e-4
MAX_FLIP_SHARE = 1e-3
KEY = jax.random.PRNGKey(7)
POLICIES = ("bf16", "int4-srft", "int8-per-token")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_port_registers_the_reference_policies():
    assert available_policies() == tuple(sorted(POLICIES))


# ---------------------------------------------------------------------------
# Store mechanics: one sequence through both stores, stats equal
# ---------------------------------------------------------------------------

def _payload(seed, nbytes=64):
    """(reference numpy payload, port torch payload), the same bytes."""
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, 255, nbytes // 2, dtype=np.uint8),
         rng.standard_normal(nbytes // 16).astype(np.float32))
    return a, tuple(torch.from_numpy(x.copy()) for x in a)


ONE = sum(x.nbytes for x in _payload(0)[0])

# (name, capacity bytes, with a disk tier, ops): ("put", key, seed),
# ("get", key), ("touch", key), ("rm_files",)
SEQUENCES = [
    ("lru_by_bytes", 2 * ONE, False, [
        ("put", b"a", 1), ("put", b"b", 2), ("touch", b"a"),
        ("put", b"c", 3), ("get", b"b"), ("put", b"a", 1),
        ("put", b"d", 4), ("get", b"a"), ("get", b"c"), ("get", b"d")]),
    ("exact_bytes_back", 1 << 16, False, [
        ("put", b"k", 7), ("get", b"k"), ("get", b"k"), ("get", b"x")]),
    ("over_budget_skips_ram", ONE - 1, False, [
        ("put", b"a", 1), ("get", b"a")]),
    ("disk_spill_and_promote", ONE, True, [
        ("put", b"a", 1), ("put", b"b", 2), ("get", b"a"), ("get", b"b"),
        ("put", b"c", 3), ("touch", b"a"), ("get", b"c")]),
    ("vanished_spill_file", 0, True, [
        ("put", b"a", 1), ("put", b"b", 2), ("rm_files",), ("get", b"a"),
        ("get", b"b")]),
]


@pytest.mark.parametrize("name,cap,disk,ops", SEQUENCES,
                         ids=[s[0] for s in SEQUENCES])
def test_store_stats_equal_the_reference_store(tmp_path, name, cap, disk,
                                               ops):
    dirs = {"ref": tmp_path / "ref", "port": tmp_path / "port"}
    ref = JPrefixStore(cap, str(dirs["ref"]) if disk else None)
    got = PrefixStore(cap, str(dirs["port"]) if disk else None)
    for op in ops:
        if op[0] == "put":
            a, t = _payload(op[2])
            ref.put(op[1], a)
            got.put(op[1], t)
        elif op[0] == "touch":
            ref.touch(op[1])
            got.touch(op[1])
        elif op[0] == "rm_files":
            for d in dirs.values():
                for f in d.iterdir():
                    f.unlink()
        else:
            a, t = ref.get(op[1]), got.get(op[1])
            assert (a is None) == (t is None), op
            for x, y in zip(a or (), t or ()):
                assert y.dtype == torch.from_numpy(x).dtype
                np.testing.assert_array_equal(y.numpy(), x)
        assert got.stats() == ref.stats(), op
        assert got.nbytes == ref.nbytes
        assert len(got) == len(ref)
        for k in (b"a", b"b", b"c", b"d", b"k"):
            assert (k in got) == (k in ref)
    if disk:
        assert len(list(dirs["port"].iterdir())) == \
            len(list(dirs["ref"].iterdir()))


def test_store_round_trips_bf16_through_disk_without_ml_dtypes(tmp_path):
    x = torch.arange(48, dtype=torch.float32).reshape(2, 3, 8).bfloat16()
    st = PrefixStore(0, str(tmp_path))
    st.put(b"x", (x, x.to(torch.int8)))
    back = st.get(b"x")
    assert back[0].dtype == torch.bfloat16 and back[0].shape == x.shape
    assert torch.equal(back[0].view(torch.int16), x.view(torch.int16))
    assert back[1].dtype == torch.int8
    assert st.stats()["disk_loads"] == 1


def test_store_rejects_negative_capacity():
    with pytest.raises(ValueError, match="capacity"):
        PrefixStore(capacity_bytes=-1)
    with pytest.raises(ValueError, match="capacity"):
        JPrefixStore(capacity_bytes=-1)


# ---------------------------------------------------------------------------
# Policy bytes: export -> import == adopt, and the reference's export
# ---------------------------------------------------------------------------

def _kv(seed, S=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, H, S, D)).astype(np.float32)
            for _ in "kv"]


def _bf16(x):
    return torch.from_numpy(x).bfloat16()


def _port_paged(policy, k, v, rots=None):
    """A 2-row pool whose row 0 holds a prefill of k, v: (pol, state,
    the row's first len // PAGE pages)."""
    pol = get_policy(policy)
    max_pages = S_MAX // PAGE
    row = pol.init_state(1, H, S_MAX, D, device="cpu", ragged=True)
    pg = pol.init_paged(2, H, S_MAX, D, n_pages=2 * max_pages + 1,
                        page_size=PAGE, device="cpu")
    if rots is not None:
        row = pol.with_rotations(row, *rots)
        pg = pol.with_rotations(pg, *rots)
    pol.prefill(row, _bf16(k), _bf16(v))
    pol.insert_row_paged(pg, row, 0, [], 0, max_pages)
    pd = getattr(pg.data, "kv", pg.data)
    return pol, pg, pd.table_host[0, :k.shape[2] // PAGE].tolist()


def _leaves(state):
    d = state.data
    kv = getattr(d, "kv", d)
    return {f.name: getattr(kv, f.name) for f in dataclasses.fields(kv)
            if isinstance(getattr(kv, f.name), torch.Tensor)}


@pytest.mark.parametrize("policy", POLICIES)
def test_export_import_equals_adopt_prefix(policy):
    """``import_pages`` over exported bytes builds the staging row that
    ``adopt_prefix`` builds from the same pages while resident, every
    leaf bit for bit; the export is one CPU tensor per pool leaf."""
    k, v = _kv(1)
    pol, pg, pages = _port_paged(policy, k, v)
    payload = pol.export_pages(pg, pages)
    pd = getattr(pg.data, "kv", pg.data)
    assert len(payload) == len(pd.pools)
    for leaf, pool in zip(payload, pd.pools):
        assert leaf.device.type == "cpu" and leaf.dtype == pool.dtype
        assert leaf.shape == (len(pages), *pool.shape[1:])
    adopted = pol.adopt_prefix(pol.init_state(1, H, S_MAX, D, device="cpu",
                                              ragged=True), pg, pages, 32)
    imported = pol.import_pages(pol.init_state(1, H, S_MAX, D, device="cpu",
                                               ragged=True), payload, 32)
    a, b = _leaves(adopted), _leaves(imported)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), f"{policy}: {name}"
    assert int(b["length"][0]) == 32


def _assert_codes(got, ref, y_exact, scales):
    cg = packing.unpack_int4(got).numpy().astype(np.int32)
    cr = packing.unpack_int4(torch.from_numpy(np.array(ref))).numpy().astype(
        np.int32)
    diff = cg - cr
    assert np.abs(diff).max() <= 1
    ratio = y_exact / np.repeat(np.asarray(scales, np.float64), GROUP, -1)
    near_tie = np.abs(np.abs(ratio) % 1.0 - 0.5) < TIE_BAND
    assert not np.any((diff != 0) & ~near_tie), "a code flipped off a tie"
    assert (diff != 0).mean() <= MAX_FLIP_SHARE


def _bits(x):
    """Comparable bytes of a tensor or array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("policy", POLICIES)
def test_exported_bytes_match_the_reference(policy):
    """The same prefill in both packages (int4: the reference's rotations
    bridged), exported from the same pages: bf16 and int8 equal, int4
    codes up to .5 ties and scales within rtol 1e-6."""
    k, v = _kv(2)
    jpol = jget_policy(policy)
    max_pages = S_MAX // PAGE
    jrow = jpol.init_state(1, H, S_MAX, D, key=KEY, ragged=True)
    jrow = jpol.prefill(jrow, jnp.asarray(k, jnp.bfloat16),
                        jnp.asarray(v, jnp.bfloat16))
    jpg = jpol.init_paged(2, H, S_MAX, D, n_pages=2 * max_pages + 1,
                          page_size=PAGE, key=KEY)
    jpg = jpol.insert_row_paged(
        jpg, jrow, 0, jnp.full((max_pages,), NULL_PAGE, jnp.int32),
        jnp.int32(0), jnp.int32(max_pages))
    rots = None
    if policy == "int4-srft":
        d = jrow.data
        rots = [Rotation(torch.from_numpy(np.array(r.matrix)),
                         torch.from_numpy(np.array(r.lam)),
                         torch.from_numpy(np.array(r.signs)), r.kind)
                for r in (d.rot_k, d.rot_v)]
    pol, pg, pages = _port_paged(policy, k, v, rots)
    jpd = jpg.data.kv if policy == "int4-srft" else jpg.data
    assert np.asarray(jpd.page_table)[0, :len(pages)].tolist() == pages
    want = jpol.export_pages(jpg, pages)
    got = pol.export_pages(pg, pages)
    assert len(got) == len(want)
    if policy != "int4-srft":
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(_bits(g), _bits(w))
        return
    for side, (raw, rot) in enumerate(zip((k, v), rots)):
        pk, sc = 2 * side, 2 * side + 1
        np.testing.assert_allclose(got[sc].numpy(), want[sc], rtol=1e-6)
        # (NP, H, ps, c) tiles of the rotated raw values, float64
        x = _bf16(raw).double().numpy()[0]  # (H, S, d)
        y = (x @ rot.matrix.double().numpy().T) * rot.lam.double().numpy()
        y = y.reshape(H, len(pages), PAGE, D).transpose(1, 0, 2, 3)
        _assert_codes(got[pk], want[pk], y, want[sc])


# ---------------------------------------------------------------------------
# Engine oracle: retire (spill) -> re-admit (restore) == resident hit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config("smol-d64"), n_layers=2)
    model = LM(cfg, device="cpu")
    return model, model.init(model.generator(0))


def _backend(policy):
    return "kernel" if policy == "int4-srft" else "gather"


def _mk(model, params, policy="int4-srft", **kw):
    kw.setdefault("page_size", PAGE)
    kw.setdefault("prefill_chunk", PAGE)
    return BatchEngine(model, params, capacity=CAPACITY, s_max=S_MAX,
                       policy=policy, backend=_backend(policy), chunk=4,
                       paged=True, device="cpu", **kw)


def _prompt(n, seed=40):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def _run(eng, reqs):
    return {c.rid: c for c in eng.run(list(reqs))}


def _assert_pool_clean(eng):
    for st in eng.cache["attn"]:
        pd = getattr(st.data, "kv", st.data)
        rc = pd.pool.refcount
        assert rc[NULL_PAGE] == 1 and not rc[NULL_PAGE + 1:].any(), rc
    assert eng.pool_stats()["pages_used"] == 0


def _restore_vs_resident(model, params, policy, **offload_kw):
    """(a) the donor retires and spills, and the same prompt restores from
    the host tier; (b) the donor stays resident (both requests at once:
    a device hit).  The restored stream equals the resident-hit one."""
    prompt = _prompt(40)
    off = _mk(model, params, policy, **offload_kw)
    _run(off, [Request(rid=0, prompt=prompt, max_new_tokens=8)])
    assert off.n_spilled_pages == 2  # 40 tokens: 2 full prompt pages
    got = _run(off, [Request(rid=1, prompt=prompt, max_new_tokens=8)])
    assert off.n_reuse_hits_host == 1 and off.n_restored_pages == 2
    assert off.n_restored_tokens == 32  # (40 - 1) // 16 pages x 16
    ref_eng = _mk(model, params, policy)
    ref = _run(ref_eng, [Request(rid=0, prompt=prompt, max_new_tokens=8),
                         Request(rid=1, prompt=prompt, max_new_tokens=8)])
    assert ref_eng.n_reuse_hits_device == 1
    np.testing.assert_array_equal(got[1].tokens, ref[1].tokens,
                                  err_msg=f"{policy}: restored != resident")
    assert got[1].finish_reason == ref[1].finish_reason == "length"
    _assert_pool_clean(off)
    _assert_pool_clean(ref_eng)
    return off


@pytest.mark.parametrize("policy", POLICIES)
def test_restore_is_bit_identical_to_a_resident_hit(lm, policy):
    model, params = lm
    eng = _restore_vs_resident(model, params, policy, offload_bytes=1 << 24)
    stats = eng.pool_stats()
    off = stats["offload"]
    assert off["enabled"] and off["hits_host"] == 1 and off["misses"] == 1
    assert off["store"]["pages_ram"] == 2 and off["store"]["hits"] == 2
    assert stats["host_bytes"]["offload_store"] == off["store"]["ram_bytes"]
    assert eng.tier_outcomes == {"miss": {"length": 1},
                                 "host": {"length": 1}}


@pytest.mark.parametrize("policy", POLICIES)
def test_restore_equals_a_resident_hit_of_the_same_depth(lm, policy):
    """A resident donor that shares exactly the restored pages (its tail
    differs): the re-admission reuses as many tokens as the restore and
    computes the same last chunk, so the admission's logits and the
    stream are the restore's bit for bit, under every policy (against the
    same prompt resident, bf16 and int8 reuse all but the last token)."""
    model, params = lm
    prompt = _prompt(40)
    donor = prompt.copy()
    donor[32:] = (donor[32:] + 1) % 256
    logits = {}
    engines = {"host": _mk(model, params, policy, offload_bytes=1 << 24),
               "device": _mk(model, params, policy)}
    for name, eng in engines.items():
        fin = eng._finalize_pending

        def finalize(*a, _e=eng, _f=fin, _n=name):
            logits[_n, _e._pending.req.rid] = _e._pending.logits.clone()
            return _f(*a)

        eng._finalize_pending = finalize
    host = engines["host"]
    _run(host, [Request(rid=0, prompt=prompt, max_new_tokens=8)])
    got = _run(host, [Request(rid=1, prompt=prompt, max_new_tokens=8)])
    dev = engines["device"]
    ref = _run(dev, [Request(rid=0, prompt=donor, max_new_tokens=8),
                     Request(rid=1, prompt=prompt, max_new_tokens=8)])
    assert host.n_restored_tokens == dev.n_reused_tokens == 32
    assert torch.equal(logits["host", 1], logits["device", 1])
    np.testing.assert_array_equal(got[1].tokens, ref[1].tokens)
    _assert_pool_clean(host)
    _assert_pool_clean(dev)


def test_restore_from_the_disk_tier(lm, tmp_path):
    """A zero-byte RAM budget sends every spill to disk; the restore
    round-trips through the spill files, bit for bit."""
    model, params = lm
    eng = _restore_vs_resident(model, params, "int4-srft", offload_bytes=0,
                               offload_dir=str(tmp_path))
    s = eng.prefix_store.stats()
    assert s["disk_spills"] >= 2 and s["disk_loads"] >= 2
    assert s["ram_bytes"] == 0


def test_restore_racing_a_chunked_admission(lm):
    """The restore lands while a long fresh prompt is still chunked: the
    interleaving leaves the restored stream as it was."""
    model, params = lm
    prompt, long_p = _prompt(40), _prompt(48, seed=99)
    off = _mk(model, params, offload_bytes=1 << 24, prefill_budget=PAGE)
    _run(off, [Request(rid=0, prompt=prompt, max_new_tokens=8)])
    got = _run(off, [Request(rid=2, prompt=long_p, max_new_tokens=6),
                     Request(rid=1, prompt=prompt, max_new_tokens=8)])
    assert off.n_reuse_hits_host == 1
    ref = _run(_mk(model, params),
               [Request(rid=0, prompt=prompt, max_new_tokens=8),
                Request(rid=1, prompt=prompt, max_new_tokens=8)])
    np.testing.assert_array_equal(got[1].tokens, ref[1].tokens)
    _assert_pool_clean(off)


def test_cancel_during_a_pending_restore_leaks_nothing(lm):
    """A restore touches no refcount before the insert: cancelling while
    the restore-seeded admission is pending returns every page."""
    model, params = lm
    long_p = _prompt(56)
    eng = _mk(model, params, offload_bytes=1 << 24)
    _run(eng, [Request(rid=0, prompt=long_p[:40], max_new_tokens=8)])
    assert eng.n_spilled_pages == 2
    eng.submit(Request(rid=1, prompt=long_p, max_new_tokens=8))
    eng.step()  # the pending admission opens, seeded from the host tier
    assert eng.n_reuse_hits_host == 1 and eng._pending is not None
    comps = eng.cancel_all()
    assert {c.rid for c in comps} == {1}
    assert comps[0].finish_reason == "cancelled"
    _assert_pool_clean(eng)
    assert eng.tier_outcomes["host"] == {"cancelled": 1}


def test_one_page_budget_keeps_the_newest_page_and_restores_nothing(lm):
    """Pages go in page order and the LRU drops the oldest, so under a
    one-page budget the prompt's first page is evicted and the walk from
    the start misses: the reference's head-first eviction."""
    model, params = lm
    prompt = _prompt(40)
    probe = _mk(model, params, offload_bytes=1 << 24)
    _run(probe, [Request(rid=0, prompt=prompt, max_new_tokens=8)])
    one_page = probe.prefix_store.stats()["ram_bytes"] // 2
    eng = _mk(model, params, offload_bytes=one_page)
    _run(eng, [Request(rid=0, prompt=prompt, max_new_tokens=8)])
    s = eng.prefix_store.stats()
    assert s["ram_bytes"] == one_page and s["pages_ram"] == 1
    assert s["evictions"] == 1
    assert prompt[:2 * PAGE].tobytes() in eng.prefix_store
    assert prompt[:PAGE].tobytes() not in eng.prefix_store
    got = _run(eng, [Request(rid=1, prompt=prompt, max_new_tokens=8)])
    assert eng.n_reuse_hits_host == 0 and eng.n_restored_tokens == 0
    np.testing.assert_array_equal(
        got[1].tokens, _run(_mk(model, params),
                            [Request(rid=1, prompt=prompt,
                                     max_new_tokens=8)])[1].tokens)
    _assert_pool_clean(eng)


def test_offload_requires_paged_and_chunked(lm):
    model, params = lm
    kw = dict(capacity=2, s_max=S_MAX, policy="bf16", chunk=4,
              device="cpu", offload_bytes=1 << 20)
    with pytest.raises(ValueError, match="paged"):
        BatchEngine(model, params, paged=False, **kw)
    with pytest.raises(ValueError, match="chunked"):
        BatchEngine(model, params, paged=True, page_size=PAGE, **kw)


def test_free_time_prune_drops_index_entries(lm):
    """The last reference to a registered prompt dies at retirement, and
    its index entries go with it, spilled first when there is a tier."""
    model, params = lm
    for kw in ({}, {"offload_bytes": 1 << 24}):
        eng = _mk(model, params, "bf16", **kw)
        _run(eng, [Request(rid=0, prompt=_prompt(32, seed=1),
                           max_new_tokens=4)])
        assert eng._prefix_pages == {} and eng._prefix_seqs == {}
        assert eng.n_spilled_pages == (2 if kw else 0)
        _assert_pool_clean(eng)


def test_counters_equal_the_reference_engine():
    """The reference's request sequence (retire, then re-admit the same
    40-token prompt) through both engines, on bridged weights: the
    spilled pages, restored tokens, host hits and store statistics are
    equal (the payload bytes too: the same leaves and dtypes)."""
    jcfg = dataclasses.replace(jget_config("smol-d64"), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    from repro_torch.models.lm import LM

    model = LM(dataclasses.replace(get_config("smol-d64"), n_layers=2),
               device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    prompt = _prompt(40)
    jeng = JBatchEngine(jm, jp, capacity=CAPACITY, s_max=S_MAX,
                        policy="int4-srft", backend="gather", chunk=4,
                        key=KEY, paged=True, page_size=PAGE,
                        prefill_chunk=PAGE, offload_bytes=1 << 24)
    eng = _mk(model, params, offload_bytes=1 << 24)
    for rid in (0, 1):
        list(jeng.run([JRequest(rid=rid, prompt=prompt, max_new_tokens=8)]))
        _run(eng, [Request(rid=rid, prompt=prompt, max_new_tokens=8)])
        for name in ("n_spilled_pages", "n_restored_pages",
                     "n_restored_tokens", "n_reuse_hits_host",
                     "n_reuse_hits_device", "n_reuse_misses"):
            assert getattr(eng, name) == getattr(jeng, name), name
        assert eng.prefix_store.stats() == jeng.prefix_store.stats()
    assert eng.tier_outcomes == jeng.tier_outcomes
    want, got = jeng.pool_stats(), eng.pool_stats()
    assert got["offload"] == want["offload"]
    assert got["host_bytes"]["offload_store"] == \
        want["host_bytes"]["offload_store"]
