"""The port's sharding rules (``launch/partitioning.py``,
``launch/act_sharding.py``) equal the reference's spec for spec.

The reference's rules run on ``jax.eval_shape`` trees; the port's on its
own trees of the same models built on the ``meta`` device (shapes, no
storage), in the reference's layer-stacked layout (``stacked_view``).  A
stand-in mesh (``axis_names`` and a ``shape`` dict, all either rule set
reads) gives the meshes (4, 2), (2, 4), (1, 8) over ('data', 'model') and
(2, 2, 2) over ('pod', 'data', 'model').  Every config of the port's
registry at ``smoke_config`` size is covered, and the smol stand-ins and
internlm2-1.8b at full size; then a seeded sweep of random shapes (the
counterpart of ``tests/test_properties.py``'s partitioning properties).
Specs compare as tuples, exactly."""
import pytest

torch = pytest.importorskip("torch")

from types import SimpleNamespace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.configs import paper_models  # noqa: E402
from repro.launch import act_sharding as ras  # noqa: E402
from repro.launch import partitioning as rpt  # noqa: E402
from repro.launch.train import smoke_config as rsmoke  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import act_sharding as tas  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import partitioning as tpt  # noqa: E402
from repro_torch.launch.train import smoke_config as tsmoke  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402

MESHES = {
    "4x2": (("data", "model"), (4, 2)),
    "2x4": (("data", "model"), (2, 4)),
    "1x8": (("data", "model"), (1, 8)),
    "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
}
FULL = ("smol-d64", "smol-d128", "smol-d256", "internlm2-1.8b")
KV_FIELDS = ("k_packed", "k_scales", "v_packed", "v_scales", "k", "v",
             "k_codes", "v_codes", "k_residual", "v_residual")
B, S_MAX = 2, 64


def _stub(name):
    axes, dims = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))


def _ref_config(name):
    if name in rconfigs.ARCH_IDS:
        return rconfigs.get_config(name)
    return paper_models.PAPER_MODELS[name]


def _ref_path(path) -> tuple:
    out = []
    for p in path:
        if isinstance(p, jax.tree_util.DictKey):
            out.append(str(p.key))
        elif isinstance(p, jax.tree_util.GetAttrKey):
            out.append(p.name)
        elif isinstance(p, jax.tree_util.SequenceKey):
            out.append(p.idx)
        else:  # FlattenedIndexKey (a Rotation's children)
            out.append(p.key)
    return tuple(out)


def _flat_ref(specs) -> dict:
    return {_ref_path(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, JP))}


def _flat_port(specs) -> dict:
    return {p: tuple(s) for p, s in tpt.flatten_with_path(specs)}


def _rotation_key(path):
    """The path up to a rotation (its children are named differently in
    the two packages: flattened indices vs dataclass fields)."""
    for side in ("rot_k", "rot_v"):
        if side in path:
            return path[:path.index(side) + 1]
    return None


def assert_same_specs(ref: dict, got: dict, what: str):
    """Spec for spec.  Leaves only one package has: the reference's scalar
    lengths and ``pos`` of a plain cache (the port keeps Python ints) and
    the port's host page-table mirror (``table_host``).  A rotation's
    leaves compare as a multiset."""
    rots_ref, rots_got = {}, {}
    for flat, rots in ((ref, rots_ref), (got, rots_got)):
        for p in [p for p in flat if _rotation_key(p) is not None]:
            rots.setdefault(_rotation_key(p), []).append(flat.pop(p))
    assert {k: sorted(v) for k, v in rots_ref.items()} == \
        {k: sorted(v) for k, v in rots_got.items()}, what
    only_ref = set(ref) - set(got)
    only_got = set(got) - set(ref)
    assert all(p[-1] in ("length", "pos") for p in only_ref), \
        (what, sorted(only_ref, key=str)[:4])
    assert all("table_host" in p for p in only_got), \
        (what, sorted(only_got, key=str)[:4])
    bad = [(p, ref[p], got[p]) for p in set(ref) & set(got)
           if ref[p] != got[p]]
    assert not bad, (what, bad[:3])
    assert set(ref) & set(got), what


# ---------------------------------------------------------------------------
# the model trees
# ---------------------------------------------------------------------------

def _cache_kinds(family):
    if family in ("dense", "moe", "vlm"):
        return {
            "int4-ragged": dict(policy="int4-srft", ragged=True),
            "int4-plain": dict(policy="int4-srft"),
            "int4-paged": dict(policy="int4-srft", ragged=True, n_pages=9,
                               page_size=16),
            "bf16-ragged": dict(policy="bf16", ragged=True),
            "int8-paged": dict(policy="int8-per-token", ragged=True,
                               n_pages=9, page_size=16),
        }
    return {"int4-plain": dict(policy="int4-srft")}


def _trees(name, full):
    tcfg = tconfigs.get_config(name)
    rcfg = _ref_config(name)
    if not full:
        tcfg, rcfg = tsmoke(tcfg), rsmoke(rcfg)
    rm, tm = rbuild(rcfg), tbuild(tcfg, device="meta")
    out = {"params": (jax.eval_shape(rm.init, jax.random.PRNGKey(0)),
                      tpt.stacked_view(tm.init(torch.Generator())))}
    for kind, kw in _cache_kinds(tcfg.family).items():
        args = (B, S_MAX, 32) if tcfg.family == "audio" else (B, S_MAX)
        key = jax.random.PRNGKey(1)
        ref = jax.eval_shape(lambda: rm.init_cache(*args, key=key, **kw))
        out[f"cache/{kind}"] = (ref,
                                tpt.stacked_view(tm.init_cache(*args, **kw)))
    return out


CASES = [(n, False) for n in tconfigs.ARCH_IDS] + [(n, True) for n in FULL]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{n}{'-full' if f else '-smoke'}" for n, f in CASES])
def trees(request):
    return request.param, _trees(*request.param)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_equal_the_reference(trees, mesh, monkeypatch):
    (name, _), t = trees
    m = _stub(mesh)
    rp, tp = t["params"]
    assert_same_specs(_flat_ref(rpt.param_specs(rp, m)),
                      _flat_port(tpt.param_specs(tp, m)), f"{name} params")
    assert_same_specs(_flat_ref(ras.fsdp_param_specs(rp, m)),
                      _flat_port(tas.fsdp_param_specs(tp, m)),
                      f"{name} fsdp")
    monkeypatch.setenv("REPRO_SHARDING", "sp_fsdp")  # the reference's switch
    assert_same_specs(_flat_ref(rpt.param_specs(rp, m)),
                      _flat_port(tpt.param_specs(tp, m, layout="sp_fsdp")),
                      f"{name} params under sp_fsdp")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_specs_equal_the_reference(trees, mesh):
    (name, _), t = trees
    m = _stub(mesh)
    for kind in [k for k in t if k.startswith("cache/")]:
        rc, tc = t[kind]
        assert_same_specs(_flat_ref(rpt.cache_specs(rc, m)),
                          _flat_port(tpt.cache_specs(tc, m)),
                          f"{name} {kind} cache_specs")
        for split_k in (False, True):
            assert_same_specs(
                _flat_ref(rpt.serve_cache_specs(rc, m,
                                                allow_split_k=split_k)),
                _flat_port(tpt.serve_cache_specs(tc, m,
                                                 allow_split_k=split_k)),
                f"{name} {kind} serve_cache_specs split_k={split_k}")


def test_serve_specs_read_a_per_layer_state_as_the_stacked_one():
    """The serving rule indexes from the end: a per-layer state's specs
    are the stacked state's less the layer axis (what the engines use)."""
    tm = tbuild(tconfigs.get_config("internlm2-1.8b"), device="meta")
    m = _stub("1x8")
    for kw in _cache_kinds("dense").values():
        cache = tm.init_cache(4, S_MAX, **kw)
        stacked = _flat_port(tpt.serve_cache_specs(
            tpt.stacked_view(cache), m))
        one = _flat_port(tpt.serve_cache_specs(cache["attn"][0], m))
        for path, spec in one.items():
            want = stacked[("attn",) + path]
            assert spec == (want[1:] if len(want) else want), path


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_activation_specs_equal_the_reference(mesh):
    m = _stub(mesh)
    rng = np.random.default_rng(3)
    for _ in range(40):
        shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 16, 24]))
                      for _ in range(int(rng.integers(0, 4))))
        rb = {"tokens": jax.ShapeDtypeStruct(shape, jnp.int32)}
        tb = {"tokens": tpt.ShapeLeaf(shape)}
        assert _flat_ref(rpt.batch_specs(rb, m)) == \
            _flat_port(tpt.batch_specs(tb, m)), shape
    kinds = ("residual", "kv_full", "logits", "moe_gsec", "moe_gecd",
             "qkv_proj", "attn_out", "other")
    for ref_pol, port_pol in ((ras._Policy(m), tas._Policy(m)),
                              (ras._ServeExact(m), tas._ServeExact(m))):
        for _ in range(60):
            kind = kinds[int(rng.integers(len(kinds)))]
            shape = tuple(int(rng.choice([1, 2, 3, 4, 8, 16, 32]))
                          for _ in range(int(rng.integers(2, 5))))
            if kind == "moe_gsec" and len(shape) < 3:
                continue
            want = ref_pol.spec_for(kind, shape)
            got = port_pol.spec_for(kind, shape)
            assert (want is None) == (got is None), (kind, shape)
            if want is not None:
                assert tuple(want) == tuple(got), (kind, shape)


def test_hints_and_policies_move_nothing():
    """Eager and single-controller: ``hint`` returns its argument under
    every policy; ``use_policy`` sets the active one."""
    m = _stub("4x2")
    x = torch.ones(2, 3, 4)
    assert tas._ACTIVE.get() is None
    for name in ("baseline", "serve_exact", "sp_fsdp"):
        with tas.use_policy(m, name):
            assert tas.hint(x, "residual") is x
            pol = tas._ACTIVE.get()
            assert (pol is None) == (name == "baseline")
    assert tas._ACTIVE.get() is None


def _spec_is_valid(spec, shape, mesh) -> bool:
    """One mesh axis used at most once, every assigned dim divisible."""
    if len(spec) > len(shape):
        return False
    used = []
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if any(a in used for a in axes):
            return False
        used += axes
        if shape[i] % int(np.prod([mesh.shape[a] for a in axes])):
            return False
    return True


def test_seeded_sweep_of_random_shapes():
    """The counterpart of ``tests/test_properties.py:318-335``: on random
    shapes and meshes, ``auto_spec``, ``cache_specs`` and
    ``serve_cache_specs`` equal the reference's and stay valid; split-K
    is opt-in and never touches a residual ring."""
    rng = np.random.default_rng(11)
    for _ in range(300):
        axes = ("data", "model") if rng.random() < 0.7 else \
            ("pod", "data", "model")
        dims = tuple(int(rng.choice([1, 2, 3, 4, 8])) for _ in axes)
        m = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))
        rank = int(rng.integers(1, 6))
        shape = tuple(int(rng.choice([1, 2, 3, 4, 5, 6, 8, 9, 16, 64]))
                      for _ in range(rank))
        skip = int(rng.integers(0, min(rank, 2) + 1))
        bdim = 0 if rng.random() < 0.3 else None
        if bdim is not None and skip:
            skip = 0
        want = rpt.auto_spec(shape, m, skip_dims=skip, batch_dim=bdim)
        got = tpt.auto_spec(shape, m, skip_dims=skip, batch_dim=bdim)
        assert tuple(want) == tuple(got), (shape, dims, skip, bdim)
        assert _spec_is_valid(got, shape, m)
        field = KV_FIELDS[int(rng.integers(len(KV_FIELDS)))]
        top = ("attn", "ssm_super", "mlstm", "pool")[int(rng.integers(4))]
        rtree = {top: {field: jax.ShapeDtypeStruct(shape, jnp.uint8),
                       "length": jax.ShapeDtypeStruct(shape[:1], jnp.int32)}}
        ttree = {top: {field: tpt.ShapeLeaf(shape),
                       "length": tpt.ShapeLeaf(shape[:1])}}
        for split_k in (False, True):
            assert_same_specs(
                _flat_ref(rpt.serve_cache_specs(rtree, m,
                                                allow_split_k=split_k)),
                _flat_port(tpt.serve_cache_specs(ttree, m,
                                                 allow_split_k=split_k)),
                f"serve {shape} {dims}")
        if "model" in axes:
            cs = _flat_port(tpt.cache_specs(ttree, m))
            assert_same_specs(_flat_ref(rpt.cache_specs(rtree, m)), dict(cs),
                              f"cache {shape} {dims}")
            for spec in cs.values():
                assert _spec_is_valid(spec, shape, m), (shape, spec)
    # split-K: only dense seq-major leaves take the sequence, and only
    # where the heads fail
    m = _stub("1x8")
    tree = {"k_packed": tpt.ShapeLeaf((2, 1, 3, 64, 8)),
            "k_residual": tpt.ShapeLeaf((2, 1, 3, 64, 8))}
    specs = tpt.serve_cache_specs(tree, m, allow_split_k=True)
    assert specs["k_packed"][3] == "model"
    assert specs["k_residual"] == tpt.P()
    assert tpt.serve_cache_specs(tree, m)["k_packed"] == tpt.P()


def test_meshes_and_the_card_figures():
    """``make_production_mesh`` raises naming the device count where the
    host has fewer; a repeated device list builds it; ``data_axes``;
    ``HW`` holds the H100's data-sheet figures."""
    with pytest.raises(RuntimeError, match="256 devices; this host has"):
        tmesh.make_production_mesh()
    m = tmesh.make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.data_axes(m) == ("pod", "data")
    assert tmesh.data_axes(_stub("4x2")) == ("data",)
    assert tmesh.HW.DATASHEET_HBM_BYTES_PER_S == 3.35e12
    assert tmesh.HW.DATASHEET_BF16_FLOP_PER_S == 989e12
    assert tmesh.HW.DATASHEET_FP32_FLOP_PER_S == 67e12
