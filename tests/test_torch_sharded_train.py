"""Sharded training on the CPU (``launch/sharded_train.py``): the
single-controller step on simulated meshes of ``cpu`` against the port's
single-device step and the reference's, the per-layer specs against the
reference's rules, the other families, and the elastic re-mesh of a
checkpoint (``CheckpointManager.restore(sharding_fn=)``,
``TrainSupervisor.maybe_resume``).

The reference's own sharded-step test is red in JAX on this tree, so the
port is held three ways: to its own single-device step, on fp32 params and
activations (the same arithmetic, the shards' gradients summed in another
order): loss and grad norm within LOSS_RTOL, every leaf within LEAF_ATOL;
to the reference's single-device ``make_train_step`` on bridged params and
the same batch and loss mask, bf16 as the models run: the loss within the
reference test's rtol 2e-3; and a mesh of one data index to the
single-device step bit for bit.  Sizes: the reference test's
``reduced(internlm2-1.8b)`` and batch (8, 32), 2 steps; the other
families one step on (2, 1).  Inputs come from numpy seeds."""
import contextlib
import functools
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import partitioning as rpt  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import leaves  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataIterator, SyntheticCorpus  # noqa: E402
from repro_torch.distributed import TrainSupervisor  # noqa: E402
from repro_torch.launch import partitioning as pt  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharded_train import (  # noqa: E402
    make_sharded_train_step,
    shard_train_state,
    split_batch,
    train_state_specs,
)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import smoke_config  # noqa: E402
from repro_torch.models import build_model, common  # noqa: E402
from repro_torch.optim.adam import AdamState, adam_init  # noqa: E402
from repro_torch.optim.adam import tree_leaves, tree_map  # noqa: E402

LR = 1e-3
# fp32: loss and grad norm are the same sums in another order (measured
# <= 1.5e-7 relative, 8.1e-7 for xlstm)
LOSS_RTOL = 1e-5
# Adam moves an element by about +-lr a step whatever its gradient's size,
# so an element whose gradient lies within fp32 rounding of 0 may move the
# other way: a leaf is held to a share of lr, not of its own size
# (measured <= 0.004 lr on internlm2, 0.048 lr on zamba2's smoke config;
# 0.22 lr on internlm2-1.8b at full width, 8 layers, on an H100)
LEAF_ATOL = 0.5 * LR
REF_RTOL = 2e-3  # tests/test_distributed.py's sharded vs single device
MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "1x2": ((1, 2), ("data", "model")),
}
B, S = 8, 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _fp32():
    """fp32 activations (the models' bf16 cast switched off)."""
    saved = common.COMPUTE_DTYPE
    common.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        common.COMPUTE_DTYPE = saved


def _mesh(name):
    dims, axes = MESHES[name]
    return make_mesh(dims, axes, devices=["cpu"] * int(np.prod(dims)))


def _batch(cfg, seed, *, masked, rows=B, seq=S, patches=0):
    """Tokens, and a 0/1 loss mask whose count differs between the first
    and the second half of the rows (the data shards of a 2-way split:
    all ones against a seeded draw)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (rows, seq))).long()}
    if masked:
        mask = rng.integers(0, 2, (rows, seq)).astype(np.int32)
        mask[: rows // 2] = 1
        mask[-1] = 0
        batch["loss_mask"] = torch.from_numpy(mask)
    if patches:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (rows, patches, cfg.d_model)).astype(np.float32))
    return batch


def _fp32_state(model, seed=0):
    params = tree_map(lambda t: t.float(), model.init(model.generator(seed)))
    return params, adam_init(params)


def _gathered(tree):
    return pt.gather_tree(tree, "cpu")


def _leaves_close(got, want, atol=LEAF_ATOL):
    ga, wa = tree_leaves(_gathered(got)), tree_leaves(want)
    assert len(ga) == len(wa)
    worst = 0.0
    for a, b in zip(ga, wa):
        assert a.dtype == b.dtype and a.shape == b.shape
        worst = max(worst, float((a.double() - b.double()).abs().max()))
    assert worst <= atol, worst
    return worst


@functools.lru_cache(maxsize=None)
def _internlm2():
    return build_model(reduced(get_config("internlm2-1.8b")), device="cpu")


@functools.lru_cache(maxsize=None)
def _single_device(masked: bool):
    """Two single-device steps on fp32 params: (state after step 2,
    [metrics of steps 1 and 2])."""
    model = _internlm2()
    with _fp32():
        params, opt = _fp32_state(model)
        step = make_train_step(model, lr=LR)
        batch = _batch(model.cfg, 1, masked=masked)
        mets = []
        for _ in range(2):
            params, opt, m = step(params, opt, batch)
            mets.append(m)
    return (params, opt), mets


def _piece_bytes_ok(tree, mesh):
    """Every piece of every leaf holds global bytes / its dims' split, on
    its mesh device (a replicated leaf in full)."""
    for s in tree_leaves(tree):
        assert isinstance(s, pt.Sharded) and s.mesh is mesh
        split = int(np.prod([n for _, _, n in pt._dim_splits(s.spec, mesh)]))
        whole = int(np.prod(s.shape)) * s.pieces.flat[0].element_size()
        for idx in np.ndindex(mesh.devices.shape):
            t = s.pieces[idx]
            assert t.device == mesh.devices[idx]
            assert t.numel() * t.element_size() * split == whole


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
@pytest.mark.parametrize("layout", ["baseline", "sp_fsdp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_step_matches_the_single_device_step(mesh_name, layout,
                                                     masked):
    """2 steps on (4, 2), (2, 2, 2) over ('pod', 'data', 'model') (the
    port's counterpart of the reference's multipod lowering test, run
    rather than lowered) and (1, 2), both layouts, with and without a
    mask whose count differs between the data shards: loss and grad norm
    within LOSS_RTOL of the single-device step's, every leaf within
    LEAF_ATOL; (1, 2), one data index, bit for bit; every piece of params
    and Adam state global / split bytes on its device."""
    model, mesh = _internlm2(), _mesh(mesh_name)
    (want_p, want_o), want_m = _single_device(masked)
    with _fp32():
        params, opt = _fp32_state(model)
        params, opt = shard_train_state(params, opt, mesh, layout=layout)
        step = make_sharded_train_step(model, mesh, lr=LR, layout=layout)
        batch = _batch(model.cfg, 1, masked=masked)
        for want in want_m:
            params, opt, m = step(params, opt, batch)
            for k in ("loss", "grad_norm", "ce"):
                np.testing.assert_allclose(float(m[k]), float(want[k]),
                                           rtol=LOSS_RTOL, err_msg=k)
    _piece_bytes_ok(params, mesh)
    _piece_bytes_ok(opt.mu, mesh)
    _piece_bytes_ok(opt.nu, mesh)
    assert int(_gathered(opt.step)) == 2
    if mesh_name == "1x2":
        assert float(m["loss"]) == float(want["loss"])
        _leaves_close((params, opt), (want_p, want_o), atol=0.0)
    else:
        _leaves_close(params, want_p)


@pytest.mark.parametrize("layout", ["baseline", "sp_fsdp"])
def test_layer_specs_are_the_reference_rules_per_layer(layout, monkeypatch):
    """``layer_param_specs`` on the port's per-layer tree equals the
    reference's ``param_specs`` on its stacked tree, the layer axis
    dropped (``REPRO_SHARDING`` selects the reference's layout); Adam's
    moments take the param's spec and its step P()."""
    if layout == "sp_fsdp":
        monkeypatch.setenv("REPRO_SHARDING", "sp_fsdp")
    for name in ("2x2x2", "4x2"):
        dims, axes = MESHES[name]
        mesh = _mesh(name)
        jm = jbuild(jreduced(jget_config("internlm2-1.8b")))
        ref = rpt.param_specs(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                              _stub(dims, axes))
        params = _internlm2().init(_internlm2().generator(0))
        specs, ospecs = train_state_specs(params, mesh, layout=layout)
        assert ospecs.step == pt.P() and ospecs.mu is specs is ospecs.nu
        flat_ref = {tuple(_key(k) for k in path): tuple(s) for path, s in
                    jax.tree_util.tree_leaves_with_path(
                        ref, is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))}
        for path, spec in pt.flatten_with_path(specs):
            if path[0] == "blocks":
                want = flat_ref[("blocks", *path[2:])][1:]
            else:
                want = flat_ref[path]
            assert tuple(spec) == want, (name, path, spec, want)


def _stub(dims, axes):
    """A stand-in mesh: the axis names and sizes the reference's rules
    read."""
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))


def _key(k):
    return str(k.key) if hasattr(k, "key") else k.name


def test_sharded_step_tracks_the_reference_single_device_step():
    """The reference's single-device ``make_train_step`` (jitted) and the
    port's sharded step on (4, 2), from the same bridged params, on the
    same batch and loss mask, bf16 as the models run: each step's loss
    within the reference test's rtol 2e-3."""
    jm = jbuild(jreduced(jget_config("internlm2-1.8b")))
    jp, jopt = jsteps.init_train_state(jm, jax.random.PRNGKey(0))
    jstep = jax.jit(jsteps.make_train_step(jm, lr=LR))
    model, mesh = _internlm2(), _mesh("4x2")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    params, opt = shard_train_state(params, adam_init(params), mesh)
    step = make_sharded_train_step(model, mesh, lr=LR)
    batch = _batch(model.cfg, 2, masked=True)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jbatch["tokens"] = jbatch["tokens"].astype(jnp.int32)
    for _ in range(2):
        jp, jopt, jm_ = jstep(jp, jopt, jbatch)
        params, opt, m = step(params, opt, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=REF_RTOL)


@pytest.mark.parametrize("arch,rows,seq,patches", [
    ("llava-next-34b", 4, 24, 8),  # a vlm with patches
    ("dbrx-132b", 4, 32, 0),  # MoE: groups of 32 divide a shard's 64
    ("zamba2-7b", 2, 32, 0),  # hybrid, smoke config
], ids=["vlm", "moe", "hybrid"])
def test_other_families_one_step_on_2x1(arch, rows, seq, patches):
    """One step on (2, 1) against the single-device step, fp32: loss,
    grad norm, cross entropy and MoE aux within LOSS_RTOL (the aux from
    the shards' mean routing shares equals the whole batch's), every leaf
    within LEAF_ATOL."""
    cfg = (smoke_config if arch == "zamba2-7b" else reduced)(get_config(arch))
    model = build_model(cfg, device="cpu")
    mesh = make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    batch = _batch(cfg, 3, masked=True, rows=rows, seq=seq, patches=patches)
    with _fp32():
        params, opt = _fp32_state(model)
        want_p, _, want = make_train_step(model, lr=LR)(params, opt, batch)
        got_p, _, got = make_sharded_train_step(model, mesh, lr=LR)(
            params, opt, batch)
    for k in ("loss", "grad_norm", "ce", "aux"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert (float(got["aux"]) > 0) == (cfg.moe is not None)
    _leaves_close(got_p, want_p)


def test_moe_groups_that_do_not_divide_a_shard_raise():
    """reduced dbrx groups at most 32 tokens: a batch of 2 x 8 is one
    group of 16, which a shard's 8 tokens cannot hold, so the step
    refuses rather than route other groups."""
    cfg = reduced(get_config("dbrx-132b"))
    model = build_model(cfg, device="cpu")
    mesh = make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    params = model.init(model.generator(0))
    step = make_sharded_train_step(model, mesh, lr=LR)
    batch = _batch(cfg, 4, masked=False, rows=2, seq=8)
    with pytest.raises(ValueError, match="do not divide a data shard"):
        step(params, adam_init(params), batch)


def test_a_batch_that_does_not_divide_is_computed_once():
    """3 rows over 2 data indices: ``batch_specs`` replicates the batch,
    the step computes it once on the lead and equals the single-device
    step."""
    model = _internlm2()
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    batch = _batch(model.cfg, 5, masked=True, rows=3)
    assert [d for d, _ in split_batch(batch, mesh)] == [mesh.lead]
    with _fp32():
        params, opt = _fp32_state(model)
        want_p, _, want = make_train_step(model, lr=LR)(params, opt, batch)
        got_p, _, got = make_sharded_train_step(model, mesh, lr=LR)(
            params, opt, batch)
    assert float(got["loss"]) == float(want["loss"])
    _leaves_close(got_p, want_p, atol=0.0)


# ------------------------------------------------------- elastic re-mesh

def test_elastic_resharding_checkpoint(tmp_path):
    """The reference's ``test_elastic_resharding_checkpoint`` in the port:
    an 8 x 8 leaf saved under a (4, 2) mesh, restored under (2, 4) through
    ``sharding_fn``: equal values, the new placement."""
    tree = {"w": torch.arange(64.0).reshape(8, 8)}
    mgr = CheckpointManager(str(tmp_path))
    mesh_a = make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    wa = pt.place(tree["w"], pt.P("data", "model"), mesh_a)
    mgr.save(5, {"w": wa}, metadata={"mesh": [4, 2]})
    mesh_b = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    spec_b = pt.P("data", "model")
    restored, meta = mgr.restore(5, tree,
                                 sharding_fn=lambda i, ex: (mesh_b, spec_b))
    w = restored["w"]
    assert isinstance(w, pt.Sharded) and w.mesh is mesh_b and w.spec == spec_b
    assert w.pieces.shape == (2, 4) and w.pieces[1, 3].shape == (4, 2)
    assert torch.equal(w.pieces[1, 3], tree["w"][4:, 6:])
    assert torch.equal(_gathered(w), tree["w"])
    assert meta["mesh"] == [4, 2]


def test_sharded_train_state_saves_as_unsharded_and_remeshes(tmp_path):
    """A (params, AdamState) after a step on (2, 2, 2): saved sharded, its
    files equal the gathered state's; restored onto one device (an
    example of plain tensors) bit for bit; restored onto (4, 2) by the new
    mesh's specs (``sharding_fn``), every piece on its device with the new
    split and the gathered leaves bit for bit."""
    model = _internlm2()
    mesh = _mesh("2x2x2")
    params = model.init(model.generator(0))
    state = shard_train_state(params, adam_init(params), mesh)
    state = make_sharded_train_step(model, mesh, lr=LR)(
        *state, _batch(model.cfg, 6, masked=True))[:2]
    plain = _gathered(state)
    a, b = CheckpointManager(str(tmp_path / "a")), CheckpointManager(
        str(tmp_path / "b"))
    a.save(1, state)
    b.save(1, plain)
    for name in ("arrays.npz", "meta.json"):
        assert (tmp_path / "a" / "step_00000001" / name).read_bytes() == \
            (tmp_path / "b" / "step_00000001" / name).read_bytes()
    one, _ = a.restore(1, tree_map(torch.zeros_like, plain))
    for x, y in zip(tree_leaves(one), tree_leaves(plain)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    new_mesh = _mesh("4x2")
    specs = leaves(train_state_specs(params, new_mesh))
    moved, _ = a.restore(1, state,
                         sharding_fn=lambda i, ex: (new_mesh, specs[i]))
    assert isinstance(moved[1], AdamState)
    for s, spec in zip(leaves(moved), specs):
        assert s.mesh is new_mesh and s.spec == spec
    _piece_bytes_ok(moved[0], new_mesh)
    for x, y in zip(tree_leaves(_gathered(moved)), tree_leaves(plain)):
        assert torch.equal(x, y)
    # None keeps a Sharded example's own placement
    kept, _ = a.restore(1, state)
    assert all(s.mesh is mesh for s in leaves(kept))


def test_maybe_resume_remeshes_and_restores_the_iterator(tmp_path):
    """``TrainSupervisor.maybe_resume(sharding_fn=)``: the latest
    checkpoint of a (2, 2) run comes back on a (1, 2) mesh by its specs,
    and the data iterator continues where the saved one stopped."""
    model = _internlm2()
    mesh, new_mesh = (make_mesh((2, 2), ("data", "model"),
                                devices=["cpu"] * 4), _mesh("1x2"))
    params = model.init(model.generator(0))
    it = DataIterator(SyntheticCorpus(3), batch_per_shard=4, seq_len=16,
                      device="cpu")
    sup = TrainSupervisor(CheckpointManager(str(tmp_path)), it, ckpt_every=2)
    step = make_sharded_train_step(model, mesh, lr=LR)

    def step_fn(state, batch):
        p, o, _ = step(*state, batch)
        return (p, o), {}

    state, reached = sup.run(shard_train_state(params, adam_init(params),
                                               mesh), step_fn,
                             start_step=0, num_steps=2)
    assert reached == 2
    it2 = DataIterator(SyntheticCorpus(3), batch_per_shard=4, seq_len=16,
                       device="cpu")
    sup2 = TrainSupervisor(CheckpointManager(str(tmp_path)), it2)
    specs = leaves(train_state_specs(params, new_mesh))
    resumed, start = sup2.maybe_resume(
        shard_train_state(params, adam_init(params), new_mesh),
        sharding_fn=lambda i, ex: (new_mesh, specs[i]))
    assert start == 2 and it2.step == 2
    assert torch.equal(it2.next()["tokens"], it.next()["tokens"])
    assert all(s.mesh is new_mesh for s in leaves(resumed))
    for x, y in zip(tree_leaves(_gathered(resumed)),
                    tree_leaves(_gathered(state))):
        assert torch.equal(x, y)
