"""The port's analytic tooling and the ``KVCachePolicy`` protocol against
the reference's (``launch/specs.py``, ``launch/roofline.py``,
``launch/dryrun.py``, ``configs.SHAPES``, ``steps.make_decode_step``,
``core/cache_api.KVCachePolicy``).

The reference works on ``jax.eval_shape`` trees; the port on trees of
tensors on the ``meta`` device (shapes and dtypes, no storage), compared
in the reference's layer-stacked layout (``partitioning.stacked_view``).
Leaves only one package has are named and left out of both sides: the
reference's scalar ``length`` and ``pos`` of a plain cache (the port
keeps Python ints) and the port's host page-table mirror.  A rotation's
leaves compare as a multiset (flattened indices against dataclass
fields).  Per-device bytes use a stand-in mesh (``axis_names`` and a
``shape`` dict) on the reference side and the port's production mesh of
``meta`` devices.  Every comparison is exact."""
import inspect
import json
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.core import cache_api as rcache  # noqa: E402
from repro.launch import partitioning as rpt  # noqa: E402
from repro.launch import roofline as rrl  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.optim.adam import adam_init as radam_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import cache_api as tcache  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import partitioning as tpt  # noqa: E402
from repro_torch.launch import roofline as trl  # noqa: E402
from repro_torch.launch import sharded_cache as sc  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import HW, make_production_mesh  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402

ARCHS = list(rconfigs.ARCH_IDS)
DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.int8): torch.int8,
          jnp.dtype(jnp.uint8): torch.uint8,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}
ROTATION = ("rot_k", "rot_v")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference model, its eval_shape params, port model on meta,
    its params)."""
    arch = request.param
    rm = rbuild(rconfigs.get_config(arch))
    tm = tbuild(tconfigs.get_config(arch), device="meta")
    return (arch, rm, jax.eval_shape(rm.init, jax.random.PRNGKey(0)), tm,
            tm.init(torch.Generator()))


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


def _split_rotations(flat: dict) -> tuple:
    """(leaves outside rotations, {rotation path: sorted leaf values})."""
    plain, rots = {}, {}
    for p, v in flat.items():
        hit = next((i for i, n in enumerate(p) if n in ROTATION), None)
        if hit is None:
            plain[p] = v
        else:
            rots.setdefault(p[:hit + 1], []).append(v)
    return plain, {k: sorted(v) for k, v in rots.items()}


def _ref_leaves(tree) -> dict:
    return {_ref_path(p): (tuple(x.shape), DTYPES[jnp.dtype(x.dtype)])
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree) -> dict:
    return {p: (tuple(x.shape), x.dtype)
            for p, x in tpt.flatten_with_path(tpt.stacked_view(tree))}


def _one_sided(ref: dict, got: dict) -> None:
    """Drop, from both, the leaves only one package has."""
    for p in [p for p in ref if p not in got and p[-1] in ("length", "pos")]:
        del ref[p]
    for p in [p for p in got if p not in ref and "table_host" in p]:
        del got[p]


def _assert_same_leaves(ref: dict, got: dict, what: str) -> None:
    ref, rrots = _split_rotations(ref)
    got, grots = _split_rotations(got)
    _one_sided(ref, got)
    assert ref == got, (what, sorted(set(ref) ^ set(got), key=str)[:4])
    assert {k: sorted(map(str, v)) for k, v in rrots.items()} == \
        {k: sorted(map(str, v)) for k, v in grots.items()}, what


def test_shapes_and_long_context_archs_equal_the_reference():
    assert {k: tuple(vars(v).values()) for k, v in tconfigs.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in rconfigs.SHAPES.items()}
    assert tconfigs.LONG_CONTEXT_ARCHS == rconfigs.LONG_CONTEXT_ARCHS
    assert tspecs.WHISPER_DECODE_ENC_LEN == rspecs.WHISPER_DECODE_ENC_LEN


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    for name, shape in rconfigs.SHAPES.items():
        ref = {k: (tuple(v.shape), DTYPES[jnp.dtype(v.dtype)])
               for k, v in rspecs.input_specs(rcfg, shape).items()}
        got = tspecs.input_specs(tcfg, tconfigs.SHAPES[name])
        assert all(t.device.type == "meta" for t in got.values())
        assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
            ref, (arch, name)


@pytest.mark.parametrize("env", ["", "bf16", "int8-per-token"])
def test_serve_cache_shapes_equal_the_reference(pair, env, monkeypatch):
    """Every serving shape (long_500k where the arch is long-context),
    under the config's policy and the ``REPRO_KV_CACHE`` overrides (which
    an arch without a KV cache, xlstm-1.3b, ignores on both sides)."""
    arch, rm, _, tm, _ = pair
    monkeypatch.setenv("REPRO_KV_CACHE", env)
    for name, shape in rconfigs.SHAPES.items():
        if shape.kind == "train" or not dryrun.cell_is_applicable(
                arch, name)[0]:
            continue
        ref = _ref_leaves(rspecs.serve_cache_shapes(
            rm, rconfigs.get_config(arch), shape))
        cache = tspecs.serve_cache_shapes(tm, tconfigs.get_config(arch),
                                          tconfigs.SHAPES[name])
        assert all(t.device.type == "meta" for _, t in tpt.flatten_with_path(
            cache) if isinstance(t, torch.Tensor))
        _assert_same_leaves(ref, _port_leaves(cache), f"{arch} {name} {env}")


def test_count_params_and_model_flops_equal_the_reference(pair):
    """The expert leaves are found in the port's per-layer tree as the
    reference's path test finds them in its stacked one."""
    arch, _, rp, _, tp = pair
    moe = rconfigs.get_config(arch).moe
    scale = moe.top_k / moe.n_experts if moe is not None else 1.0
    got = trl.count_params(tp, moe_scale=scale)
    assert got == rrl.count_params(rp, moe_scale=scale)
    if moe is not None:
        assert got[1] < got[0]
    for name, shape in rconfigs.SHAPES.items():
        assert trl.model_flops_estimate(tconfigs.get_config(arch),
                                        tconfigs.SHAPES[name], tp) == \
            rrl.model_flops_estimate(rconfigs.get_config(arch), shape, rp)


def test_roofline_terms_equal_the_reference_on_h100_constants(monkeypatch):
    """The reference's formula with the H100's data-sheet rates put into
    its ``HW`` for the test."""
    monkeypatch.setattr(rrl.HW, "PEAK_BF16_FLOPS",
                        HW.DATASHEET_BF16_FLOP_PER_S)
    monkeypatch.setattr(rrl.HW, "HBM_BW", HW.DATASHEET_HBM_BYTES_PER_S)
    monkeypatch.setattr(rrl.HW, "ICI_BW", HW.DATASHEET_NVLINK_BYTES_PER_S)
    rng = np.random.default_rng(4)
    for _ in range(20):
        f, b, c = (float(x) for x in 10.0 ** rng.uniform(6, 18, 3))
        assert trl.roofline_terms(f, b, c) == rrl.roofline_terms(f, b, c)


def _stub(mesh):
    return SimpleNamespace(axis_names=mesh.axis_names, shape=mesh.shape)


def _ref_bytes(tree, specs, mesh) -> int:
    """The reference's leaves' bytes per device under its specs, without
    the leaves only it has."""
    spec_of = {_ref_path(p): s for p, s in jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    total = 0
    for p, x in jax.tree_util.tree_leaves_with_path(tree):
        path = _ref_path(p)
        if path[-1] in ("length", "pos") and x.ndim <= 1:
            continue
        n = x.size * jnp.dtype(x.dtype).itemsize
        total += n // dryrun._pieces(tuple(spec_of[path]), mesh)
    return total


@pytest.mark.parametrize("arch,shape_name,multi", [
    ("internlm2-1.8b", "decode_32k", False),
    ("qwen3-moe-235b-a22b", "train_4k", False),
    ("whisper-large-v3", "prefill_32k", True),
    ("zamba2-7b", "long_500k", False),
])
def test_dryrun_argument_bytes_equal_the_reference(arch, shape_name, multi,
                                                   monkeypatch):
    """Per-device argument bytes of a cell from ``dryrun.build_cell``
    against the sums the reference's specs give its ``eval_shape`` leaves
    (the reference's dry run builds its cells from the same specs)."""
    monkeypatch.delenv("REPRO_SHARDING", raising=False)
    monkeypatch.delenv("REPRO_KV_CACHE", raising=False)
    n = 512 if multi else 256
    mesh = make_production_mesh(multi_pod=multi, devices=["meta"] * n)
    stub = _stub(mesh)
    cell = dryrun.build_cell(arch, shape_name, mesh)
    got = {k: dryrun.per_device_bytes(s, sp, mesh)
           for k, (s, sp) in cell.specs.items()}
    rcfg, shape = rconfigs.get_config(arch), rconfigs.SHAPES[shape_name]
    rm = rbuild(rcfg)
    rp = jax.eval_shape(rm.init, jax.random.PRNGKey(0))
    want = {"params": _ref_bytes(rp, rpt.param_specs(rp, stub), stub)}
    if shape.kind == "train":
        opt = jax.eval_shape(radam_init, rp)
        want["opt_state"] = sum(_ref_bytes(t, rpt.param_specs(t, stub), stub)
                                for t in (opt.mu, opt.nu))
        want["batch"] = _ref_bytes(
            *(lambda b: (b, rpt.batch_specs(b, stub)))(
                rspecs.input_specs(rcfg, shape)), stub)
    else:
        cache = rspecs.serve_cache_shapes(rm, rcfg, shape)
        want["cache"] = _ref_bytes(cache, rpt.cache_specs(cache, stub), stub)
        batch = (rspecs.input_specs(rcfg, shape) if shape.kind == "prefill"
                 else {"t": rspecs.input_specs(rcfg, shape)["token"]})
        want["batch"] = _ref_bytes(batch, rpt.batch_specs(batch, stub), stub)
    assert got == want


def test_dryrun_cli_writes_its_record_without_allocating(tmp_path):
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "internlm2-1.8b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["device"] == "meta"
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["chips"] == 256
    per = rec["argument_bytes_per_device"]
    assert per["total"] == per["params"] + per["cache"] + per["batch"] > 0
    assert rec["model_flops"]["model_flops"] > 0
    assert rec["not_recorded"]["fields"] == ["hlo_bytes", "t_lower_s",
                                             "t_compile_s"]
    assert rec["cost_analysis"]["flops"] > rec["model_flops"]["model_flops"]
    skipped = json.loads((tmp_path / "internlm2-1.8b__long_500k__single.json")
                         .read_text())
    assert skipped["status"] == "skipped"
    cell = dryrun.build_cell("internlm2-1.8b", "decode_32k",
                             make_production_mesh(devices=["meta"] * 256))
    assert all(t.device.type == "meta" for a in cell.args
               for _, t in tpt.flatten_with_path(a)
               if isinstance(t, torch.Tensor))


def test_make_decode_step_is_the_models_decode_step():
    model = tbuild(tconfigs.reduced(tconfigs.get_config("internlm2-1.8b")),
                   device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.tensor([[3]])
    outs = []
    for step in (make_decode_step(model, backend="kernel"),
                 lambda p, t, c: model.decode_step(p, t, c,
                                                   backend="kernel")):
        cache = model.init_cache(1, 32, policy="int4-srft")
        _, cache = model.prefill(params, torch.tensor([[1, 2, 3, 4, 5]]),
                                 cache)
        outs.append(step(params, tok, cache)[0])
    assert torch.equal(outs[0], outs[1])


# the reference protocol's parameters the port names otherwise or adds: a
# torch.Generator where a PRNG key was, and the entry points' device
PORT_NAMES = {"key": "generator"}
PORT_EXTRA = {"device"}


def _params(fn) -> list:
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.name != "self" and p.kind is not p.VAR_KEYWORD]


def _protocol_methods(cls) -> list:
    return [n for n, v in vars(cls).items()
            if inspect.isfunction(v) and not n.startswith("_")]


def test_protocol_has_the_references_methods_and_parameter_names():
    ref = _protocol_methods(rcache.KVCachePolicy)
    assert _protocol_methods(tcache.KVCachePolicy) == ref
    assert "KVCachePolicy" in tcache.__all__
    for name in ref:
        want = [PORT_NAMES.get(p, p)
                for p in _params(getattr(rcache.KVCachePolicy, name))]
        got = [p for p in _params(getattr(tcache.KVCachePolicy, name))
               if p not in PORT_EXTRA]
        assert got == want, name


@pytest.mark.parametrize("policy", tcache.available_policies())
@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "sharded"])
def test_every_policy_conforms_to_the_protocol(policy, sharded):
    """Each protocol method is there with the protocol's parameters first,
    in its order (a policy may add keyword options after them)."""
    pol = tcache.get_policy(policy)
    if sharded:
        pol = sc.ShardedPolicy(pol)
    assert isinstance(pol, tcache.KVCachePolicy)
    for name in _protocol_methods(tcache.KVCachePolicy):
        want = _params(getattr(tcache.KVCachePolicy, name))
        got = _params(getattr(pol, name))
        assert got[:len(want)] == want, (policy, name, got)
