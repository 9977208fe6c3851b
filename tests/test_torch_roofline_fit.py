"""The depth fit (``launch/roofline_fit.py``), the op probe
(``launch/op_probe.py``) and the dry run's cost fields
(``launch/dryrun.py``) against the reference's and against the direct
census.

The reference's ``roofline_fit`` sets ``XLA_FLAGS``,
``REPRO_UNROLL_SCANS`` and ``REPRO_BF16_DOTS`` when it is imported, so it
runs in a subprocess that prints JSON: its ``depth_variants`` for every
arch, and the keys of the record its ``run_cell`` writes for a reduced
cell on a one-device mesh."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.launch import cost, dryrun, op_probe  # noqa: E402
from repro_torch.launch import roofline_fit as rf  # noqa: E402

torch.set_num_threads(1)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TINY = {"tiny_train": ShapeConfig("tiny_train", 32, 2, "train"),
        "tiny_decode": ShapeConfig("tiny_decode", 64, 2, "decode")}

_REF_SCRIPT = r"""
import json, os, tempfile
import jax
import numpy as np
from jax.sharding import Mesh
import repro.launch.roofline_fit as rf
from repro.configs import ARCH_IDS, SHAPES, get_config, reduced
from repro.configs.base import ShapeConfig

out = {"variants": {}}
for arch in ARCH_IDS:
    pts, u_full = rf.depth_variants(get_config(arch))
    out["variants"][arch] = {
        "points": [[c.n_layers, c.encoder_layers, u] for c, u in pts],
        "u_full": u_full}
SHAPES["tiny_decode"] = ShapeConfig("tiny_decode", 64, 2, "decode")
rf.get_config = lambda a: reduced(get_config(a))
rf.make_production_mesh = lambda: Mesh(
    np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
d = tempfile.mkdtemp()
rf.run_cell("internlm2-1.8b", "tiny_decode", d)
rec = json.load(open(os.path.join(d, os.listdir(d)[0])))
out["status"] = rec["status"]
out["keys"] = {"record": sorted(rec), "fitted": sorted(rec["fitted"]),
               "point": sorted(rec["points"][0]),
               "model_flops": sorted(rec["model_flops"])}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture
def tiny_shapes(monkeypatch):
    for name, shape in TINY.items():
        monkeypatch.setitem(tconfigs.SHAPES, name, shape)


def test_depth_variants_equal_the_reference(reference):
    # the port registers the smol configs besides the reference's archs
    assert set(reference["variants"]) <= set(tconfigs.ARCH_IDS)
    for arch, want in reference["variants"].items():
        pts, u_full = rf.depth_variants(get_config(arch))
        assert [[c.n_layers, c.encoder_layers, u] for c, u in pts] == \
            want["points"], arch
        assert u_full == want["u_full"], arch


def _full_depth(arch):
    """The reduced config of ``arch`` at a depth the fit extrapolates to:
    3 units (5 layers for a layer unit).  A hybrid fires its shared block
    every 2 Mamba2 blocks and an ssm model has an sLSTM every 2 blocks,
    which keeps the eager census of their train steps short."""
    cfg = reduced(get_config(arch))
    fam = cfg.family
    if fam == "hybrid":
        return dataclasses.replace(cfg, shared_attn_period=2, n_layers=7)
    if fam == "ssm":
        return dataclasses.replace(cfg, n_layers=6, xlstm=dataclasses.replace(
            cfg.xlstm, slstm_period=2))
    if fam == "audio":
        return dataclasses.replace(cfg, n_layers=5, encoder_layers=5)
    return dataclasses.replace(cfg, n_layers=5)


FAMILIES = {"dense": "internlm2-1.8b", "moe": "dbrx-132b",
            "vlm": "llava-next-34b", "hybrid": "zamba2-7b",
            "ssm": "xlstm-1.3b", "audio": "whisper-large-v3"}


# one cell a family (both for dense); the decode cells run the int4
# cache's kernels through their meta branch
FIT_CELLS = [("dense", "tiny_train"), ("dense", "tiny_decode"),
             ("moe", "tiny_train"), ("vlm", "tiny_train"),
             ("hybrid", "tiny_train"), ("ssm", "tiny_decode"),
             ("audio", "tiny_decode")]


@pytest.mark.parametrize("family,shape", FIT_CELLS)
def test_fit_equals_the_direct_full_depth_census(family, shape,
                                                 tiny_shapes):
    """Eager counting sees each layer once, so the line through the two
    reduced depths meets the full-depth census exactly."""
    arch = FAMILIES[family]
    cfg = _full_depth(arch)
    assert cfg.family == family
    rec = rf.fit_cell(arch, shape, cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["u_full"] > max(p["u"] for p in rec["points"])
    direct = rf.measure_point(arch, shape, rf.meta_mesh(), cfg)
    fitted = rec["fitted"]
    assert fitted["flops"] == direct["flops"] > 0
    assert fitted["bytes"] == direct["bytes"] > 0
    assert fitted["coll_total"] == direct["coll_total"]
    assert rec["model_flops"]["useful_ratio"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_length_fit_equals_the_direct_census(kind, monkeypatch):
    """An ssm train / prefill cell's cost at 2, 3 and 4 chunks,
    extrapolated, equals its direct census at 6 chunks: linear in the
    chunks for a prefill, quadratic for a train step (each chunk's slice
    has a whole-length gradient)."""
    base = reduced(get_config("xlstm-1.3b"))
    cfg = dataclasses.replace(base, n_layers=2, xlstm=dataclasses.replace(
        base.xlstm, slstm_period=2, chunk=8))
    shape = ShapeConfig("tiny_" + kind, 48, 2, kind)
    monkeypatch.setitem(tconfigs.SHAPES, shape.name, shape)
    mesh = rf.meta_mesh()
    cell = dryrun.build_cell("xlstm-1.3b", shape.name, mesh, cfg=cfg)
    assert dryrun.per_token_loop(cell.cfg, cell.shape)
    got = dryrun.step_cost(cell, "xlstm-1.3b", shape.name, mesh)
    want = dryrun._census(cell)
    assert got["cost_analysis"] == want["cost_analysis"]
    assert got["collectives"]["total"] == want["collectives"]["total"] == 0
    assert want["cost_analysis"]["flops"] > 0


def test_record_keys_equal_the_reference(reference, tiny_shapes,
                                         monkeypatch, tmp_path):
    monkeypatch.setattr(rf, "get_config", lambda a: reduced(get_config(a)))
    rf.run_cell("internlm2-1.8b", "tiny_decode", str(tmp_path))
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    assert path.name == "internlm2-1.8b__tiny_decode__single.json"
    assert reference["status"] == rec["status"] == "ok"
    got = {"record": sorted(rec), "fitted": sorted(rec["fitted"]),
           "point": sorted(rec["points"][0]),
           "model_flops": sorted(rec["model_flops"])}
    assert got == reference["keys"]
    rf.run_cell("internlm2-1.8b", "tiny_decode", str(tmp_path))  # resumes
    assert len(list(tmp_path.iterdir())) == 1


def test_op_probe_sums_equal_the_records_total(tiny_shapes):
    cfg = reduced(get_config("internlm2-1.8b"))
    cell = dryrun.build_cell("internlm2-1.8b", "tiny_decode", rf.meta_mesh(),
                             cfg=cfg)
    _, records = cost.cost_analysis(cell.fn, *cell.args)
    per_op, per_cnt, top = op_probe.analyze(records, top=5)
    assert sum(per_op.values()) == sum(r.bytes_written for r in records)
    assert sum(per_cnt.values()) == sum(1 for r in records if r.nbytes)
    assert [b for b, _, _ in top] == sorted(
        (r.bytes_written for r in records if r.nbytes), reverse=True)[:5]
    assert all(src.startswith("repro_torch/") for _, _, src in top), top
    lines = op_probe.report(records, top=5)
    assert lines[0].startswith("cost_analysis: flops=")
    assert len(lines) == 2 + min(18, len(per_op)) + 1 + 5


def test_dryrun_records_the_cost_of_an_int4_decode_cell(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: reduced(get_config(a)))
    monkeypatch.delenv("REPRO_KV_CACHE", raising=False)
    dryrun.run_cell("internlm2-1.8b", "decode_32k", "single", str(tmp_path))
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec["cost_analysis"]) == {"flops", "bytes accessed",
                                         "transcendentals"}
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["collectives"]["total"] == 0
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "bottleneck"}
    assert rec["model_flops"]["useful_ratio"] > 0
    assert rec["not_recorded"]["fields"] == ["hlo_bytes", "t_lower_s",
                                             "t_compile_s"]
