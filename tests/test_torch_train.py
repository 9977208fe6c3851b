"""The port's training substrates on the CPU: the data iterator's state,
``CheckpointManager`` (round trip, keep-k, atomicity, ``sharding_fn``, bf16
and ``AdamState`` leaves bit for bit, a checkpoint written by the
reference's manager), ``tree_map`` over NamedTuples, ``TrainSupervisor``
(resume, SIGTERM), the training CLI (exact resume, ``--mesh`` 1x1 equal to
no mesh and 2x1 refused on one device, no card)
and the two examples.  The counterparts of ``tests/test_substrates.py``
(data, checkpoint) run against the reference where it has the behaviour."""
import dataclasses
import json
import os
import signal

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402,E501
from repro.data import DataIterator as JDataIterator  # noqa: E402
from repro.data import SyntheticCorpus as JCorpus  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataIterator, SyntheticCorpus  # noqa: E402
from repro_torch.distributed import TrainSupervisor  # noqa: E402
from repro_torch.examples import calibrate_rotation, train_lm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim.adam import (  # noqa: E402
    AdamState,
    adam_init,
    tree_leaves,
    tree_map,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _iter(**kw):
    return DataIterator(SyntheticCorpus(seed=7), batch_per_shard=2,
                        seq_len=64, device="cpu", **kw)


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ------------------------------------------------------------------ data

def test_data_deterministic_and_resumable():
    it1 = _iter()
    b0, b1 = it1.next(), it1.next()
    state = it1.state_dict()
    b2 = it1.next()
    it2 = _iter()
    it2.restore(state)
    assert torch.equal(b2["tokens"], it2.next()["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    # disjoint shards differ
    it3 = _iter(shard_id=1, num_shards=2)
    assert not torch.equal(it3.next()["tokens"], b0["tokens"])


def test_iterator_state_matches_reference():
    """The reference's keys and behaviour: ``restore`` sets only the step,
    ``reshard`` keeps it."""
    it, jit = _iter(), JDataIterator(JCorpus(seed=7), batch_per_shard=2,
                                     seq_len=64)
    for _ in range(3):
        np.testing.assert_array_equal(it.next()["tokens"].numpy(),
                                      jit.next()["tokens"])
    assert it.state_dict() == jit.state_dict() == {
        "step": 3, "shard_id": 0, "num_shards": 1}
    other = _iter(shard_id=1, num_shards=2)
    other.restore(it.state_dict())
    assert other.state_dict() == {"step": 3, "shard_id": 1, "num_shards": 2}
    it.reshard(1, 4)
    jit.reshard(1, 4)
    assert it.state_dict() == jit.state_dict()
    np.testing.assert_array_equal(it.next()["tokens"].numpy(),
                                  jit.next()["tokens"])


# ------------------------------------------------------------ checkpoints

def test_checkpoint_roundtrip_keepk_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)}
    for step in [10, 20, 30]:
        mgr.save(step, tree, metadata={"data": {"step": step}})
    assert mgr.latest_step() == 30
    assert sorted(os.listdir(tmp_path)) == ["step_00000020", "step_00000030"]
    restored, meta = mgr.restore(30, tree)
    _assert_trees_equal(restored, tree)
    assert meta["data"]["step"] == 30
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    # a write cut mid-way leaves a .tmp that latest_step ignores
    os.makedirs(tmp_path / "step_00000040.tmp")
    assert mgr.latest_step() == 30


def test_checkpoint_device_fn_called_once_per_leaf(tmp_path):
    """``sharding_fn`` (which took over the single-device ``device_fn``)
    is called once a leaf; a device or None places the leaf whole."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(16.0).reshape(4, 4), "v": [torch.ones(2)]}
    mgr.save(1, tree)
    placed = []

    def sharding_fn(i, ex):
        placed.append(i)
        return None if i == 0 else torch.device("cpu")

    restored, _ = mgr.restore(1, tree, sharding_fn=sharding_fn)
    assert sorted(placed) == [0, 1]
    _assert_trees_equal(restored, tree)


def test_tree_map_keeps_namedtuples():
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(3, generator=g), "b": [torch.randn(2, 2)]}
    opt = adam_init(params)
    doubled = tree_map(lambda t: t * 2, opt)
    assert isinstance(doubled, AdamState)
    assert torch.equal(doubled.mu["a"], opt.mu["a"] * 2)
    pair = tree_map(lambda t: t + 1, (params, opt))
    assert type(pair) is tuple and isinstance(pair[1], AdamState)
    assert isinstance(pair[0]["b"], list)
    assert len(tree_leaves((params, opt))) == 2 + 1 + 2 + 2


def test_params_and_adam_state_roundtrip_bit_for_bit(tmp_path):
    """bf16 params with fp32 norm scales, and an AdamState past a step,
    restored into a fresh tree: every leaf equal, dtype kept."""
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models.lm import LM

    model = LM(train.smoke_config(get_config("smol-d64")), device="cpu")
    params, opt = init_train_state(model, model.generator(0))
    batch = _iter().next()
    params, opt, _ = make_train_step(model, lr=1e-3)(params, opt, batch)
    assert {t.dtype for t in tree_leaves(params)} >= {torch.bfloat16,
                                                      torch.float32}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(int(opt.step), (params, opt), metadata={"note": "x"})
    fresh = init_train_state(model, model.generator(1))
    restored, meta = mgr.restore(1, fresh)
    assert isinstance(restored[1], AdamState)
    _assert_trees_equal(restored, (params, opt))
    assert meta == {"note": "x"}
    with open(tmp_path / "step_00000001" / "meta.json") as f:
        saved = json.load(f)
    assert "bfloat16" in saved["dtypes"]
    assert saved["treedef"].count("*") == saved["n_leaves"]
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, params)


def test_reads_a_checkpoint_written_by_the_reference(tmp_path):
    w = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    jmgr = JCheckpointManager(str(tmp_path))
    jmgr.save(5, {"w": jnp.asarray(w),
                  "h": jnp.asarray(w, dtype=jnp.bfloat16)},
              metadata={"data": {"step": 5}})
    example = {"w": torch.zeros(3, 4),
               "h": torch.zeros(3, 4, dtype=torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 5
    got, meta = mgr.restore(5, example)
    assert torch.equal(got["w"], torch.from_numpy(w))
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["h"], torch.from_numpy(w).bfloat16())
    assert meta == {"data": {"step": 5}}


# ------------------------------------------------------------- supervisor

def _counting_step(state, batch):
    return {"x": state["x"] + batch["tokens"].sum()}, {}


def test_supervisor_checkpoints_and_resumes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    it = _iter()
    sup = TrainSupervisor(mgr, it, ckpt_every=2)
    state0 = {"x": torch.zeros((), dtype=torch.int64)}
    state, reached = sup.run(state0, _counting_step, start_step=0,
                             num_steps=5)
    assert reached == 5 and mgr.latest_step() == 4
    it2 = _iter()
    sup2 = TrainSupervisor(mgr, it2, ckpt_every=2)
    resumed, start = sup2.maybe_resume(state0)
    assert start == 4 and it2.step == 4
    final, _ = sup2.run(resumed, _counting_step, start_step=start,
                        num_steps=5)
    assert torch.equal(final["x"], state["x"])


def test_supervisor_saves_and_stops_on_sigterm(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    it = _iter()
    sup = TrainSupervisor(mgr, it, ckpt_every=100)
    old = signal.getsignal(signal.SIGTERM)
    try:
        calls = []

        def step(state, batch):
            calls.append(1)
            if len(calls) == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return _counting_step(state, batch)

        state, reached = sup.run({"x": torch.zeros((), dtype=torch.int64)},
                                 step, start_step=0, num_steps=50)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert reached == 3 and len(calls) == 3
    assert mgr.latest_step() == 3
    _, meta = mgr.restore(3, state)
    assert meta["data"]["step"] == 3


# -------------------------------------------------------------------- CLI

def _train(tmp, steps, *extra, on_step=None):
    return train.main(["--arch", "smol-d64", "--smoke", "--device", "cpu",
                       "--steps", str(steps), "--batch", "2", "--seq", "32",
                       "--log-every", "1", "--ckpt-dir", str(tmp), *extra],
                      on_step=on_step)


def test_train_cli_resume_is_exact(tmp_path, capsys):
    """4 steps uninterrupted == 2 steps, then a resume to 4: the returned
    state and the step-4 checkpoints (leaves and iterator state) equal,
    bit for bit (inside the 20-step warmup the schedule does not depend on
    --steps)."""
    steps_seen = []
    whole = _train(tmp_path / "a", 4, on_step=lambda s, m: steps_seen.append(
        (s, float(m["loss"]))))
    assert [s for s, _ in steps_seen] == [1, 2, 3, 4]
    assert all(np.isfinite(loss) for _, loss in steps_seen)
    _train(tmp_path / "b", 2)
    resumed = _train(tmp_path / "b", 4, "--resume")
    assert "[resume] from step 2" in capsys.readouterr().out
    _assert_trees_equal(resumed, whole)
    ma, mb = CheckpointManager(str(tmp_path / "a")), CheckpointManager(
        str(tmp_path / "b"))
    assert ma.latest_step() == mb.latest_step() == 4
    ta, meta_a = ma.restore(4, whole)
    tb, meta_b = mb.restore(4, whole)
    _assert_trees_equal(ta, tb)
    assert meta_a == meta_b == {"data": {"step": 4, "shard_id": 0,
                                         "num_shards": 1}}


def test_train_cli_mesh_and_other_families_raise():
    """--mesh asking for more devices than are visible (2 on the CPU's
    one) exits before building anything, naming them.  The hybrid, ssm
    and audio families no longer raise: smoke_config reduces each as the
    reference's does."""
    with pytest.raises(SystemExit, match="2 devices and 1 is visible"):
        train.main(["--mesh", "2x1", "--device", "cpu"])
    from repro.configs import get_config as jget_config
    from repro.launch.train import smoke_config as jsmoke

    for arch in ("zamba2-7b", "xlstm-1.3b", "whisper-large-v3"):
        got = train.smoke_config(get_config(arch))
        want = dataclasses.asdict(jsmoke(jget_config(arch)))
        assert got.family == get_config(arch).family
        assert {k: want[k] for k in dataclasses.asdict(got)} == \
            dataclasses.asdict(got), arch


def test_train_cli_mesh_1x1_equals_no_mesh(tmp_path, capsys):
    """--mesh 1x1 on the CPU: the state placed by the partitioning rules
    and the sharded step over one data index train 2 steps to the
    unmeshed CLI's state, losses and step-2 checkpoint bit for bit, and
    the [train] line names the mesh; --resume under the mesh re-places
    the restored state on it."""
    from repro_torch.launch.partitioning import Sharded, gather_tree

    seen = {"mesh": [], "none": []}
    meshed = _train(tmp_path / "m", 2, "--mesh", "1x1",
                    on_step=lambda s, m: seen["mesh"].append(float(m["loss"])))
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
    plain = _train(tmp_path / "p", 2,
                   on_step=lambda s, m: seen["none"].append(float(m["loss"])))
    assert all(isinstance(t, Sharded) for t in tree_leaves(meshed))
    _assert_trees_equal(gather_tree(meshed, "cpu"), plain)
    assert seen["mesh"] == seen["none"] and len(seen["none"]) == 2
    restored, _ = CheckpointManager(str(tmp_path / "m")).restore(2, plain)
    _assert_trees_equal(restored, plain)
    resumed = _train(tmp_path / "m", 3, "--mesh", "1x1", "--resume")
    assert "[resume] from step 2" in capsys.readouterr().out
    assert all(isinstance(t, Sharded) for t in tree_leaves(resumed))
    again = _train(tmp_path / "p", 3, "--resume")
    _assert_trees_equal(gather_tree(resumed, "cpu"), again)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_train_cli_steps_on_the_recurrent_families(arch, capsys):
    """Two steps of the training CLI on ``--smoke``: finite losses."""
    losses = []
    train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                "--seq", "16", "--device", "cpu", "--log-every", "1"],
               on_step=lambda s, m: losses.append(float(m["loss"])))
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert f"arch={arch}" in capsys.readouterr().out


def test_train_cli_layers_cuts_the_depth_only(capsys):
    """``--layers N`` (after ``--smoke``): N layers at the arch's width."""
    losses = []
    state = train.main(["--arch", "smol-d64", "--smoke", "--layers", "2",
                        "--steps", "1", "--batch", "2", "--seq", "16",
                        "--device", "cpu"],
                       on_step=lambda s, m: losses.append(float(m["loss"])))
    want = train.smoke_config(get_config("smol-d64"))
    assert want.n_layers == 4
    assert f"layers=2 d={want.d_model} " in capsys.readouterr().out
    assert len(state[0]["blocks"]) == 2 and np.isfinite(losses).all()


def test_train_cli_refuses_audio_with_a_reason():
    """The data pipeline feeds tokens only; an audio loss needs frames
    (the reference's CLI fails on the missing key inside its loss)."""
    with pytest.raises(ValueError, match="frames"):
        train.main(["--arch", "whisper-large-v3", "--smoke", "--steps", "1",
                    "--device", "cpu"])


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-large-v3"])
def test_hybrid_and_encdec_trees_roundtrip_bit_for_bit(arch, tmp_path):
    """(params, Adam state) of the hybrid's nested groups and of the
    encoder-decoder's layer lists, saved and restored into a fresh tree:
    every leaf equal, in the order ``_leaves`` gives (dict keys sorted,
    lists in order), the same order a save of that tree always used."""
    from repro_torch.models import build_model

    model = build_model(train.smoke_config(get_config(arch)), device="cpu")
    params = model.init(model.generator(0))
    opt = adam_init(params)
    opt = opt._replace(mu=tree_map(lambda t: torch.randn_like(t.float()),
                                   opt.mu))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, (params, opt))
    fresh = model.init(model.generator(1))
    restored, _ = mgr.restore(3, (fresh, adam_init(fresh)))
    _assert_trees_equal(restored, (params, opt))
    with open(tmp_path / "step_00000003" / "meta.json") as f:
        saved = json.load(f)
    assert saved["n_leaves"] == len(tree_leaves((params, opt)))


def test_entry_points_raise_without_a_card(monkeypatch):
    """No --device and no card: the CLI and both examples raise before
    building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(train, "LM", lambda *a, **k: built.append(1))
    for main in (train.main, train_lm.main, calibrate_rotation.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--steps", "1"])
    assert not built


def test_smoke_config_matches_reference_dense_branch():
    from repro.configs import get_config as jget_config
    from repro.launch.train import smoke_config as jsmoke

    for arch in ("internlm2-1.8b", "smol-d128"):
        got = dataclasses.asdict(train.smoke_config(get_config(arch)))
        want = dataclasses.asdict(jsmoke(jget_config(arch)))
        assert {k: want[k] for k in got} == got


# --------------------------------------------------------------- examples

def test_train_lm_example_runs_and_resumes(tmp_path, capsys):
    out = train_lm.main(["--device", "cpu", "--steps", "2",
                         "--ckpt-dir", str(tmp_path)])
    assert out["start"] == 0 and out["reached"] == 2
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    out = train_lm.main(["--device", "cpu", "--steps", "3",
                         "--ckpt-dir", str(tmp_path)])
    assert out["start"] == 2 and out["reached"] == 3
    assert "[resume] continuing from step 2" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]


def test_calibrate_rotation_example_runs():
    out = calibrate_rotation.main(["--device", "cpu", "--steps", "2"])
    assert out["n_vectors"] == 8 * 2 * 128
    rows = [v for v in out.values() if isinstance(v, dict)
            and "orthogonality_err" in v]
    assert len(rows) == 4
    for r in rows:
        assert r["orthogonality_err"] < 1e-4
        assert r["mse_reduction"] > 0
