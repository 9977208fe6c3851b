"""The port stands alone: no source file of ``src/repro_torch/`` or
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and
``chip_smoke.py`` refuses to run (non-zero exit, no ``"ok": true``) where
no card is visible -- there is no silent CPU fallback."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\s|$|\.|,)"
    r"|from\s+repro(\s|\.)|from\s+repro\s+import)", re.MULTILINE)


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*"))
    files = [f for f in files if f.suffix in (".py", ".cu", ".cuh")]
    return files + [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_repro():
    files = _sources()
    assert len(files) > 20
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for sub in ("checkpoint/manager.py", "distributed/fault_tolerance.py",
                "launch/train.py", "core/calibrate.py", "launch/serve.py",
                "examples/serve_int4.py", "models/moe.py",
                "launch/mesh.py", "launch/partitioning.py",
                "launch/act_sharding.py", "launch/sharded_cache.py",
                "distributed/pipeline.py",
                *(f"launch/server/{m}.py" for m in (
                    "__init__", "tracing", "stats", "trace", "admission",
                    "pipeline", "http"))):
        assert f"src/repro_torch/{sub}" in names, sub
    bad = []
    for f in files:
        for m in FORBIDDEN.finditer(f.read_text()):
            bad.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not bad, "forbidden imports:\n" + "\n".join(bad)


def test_forbidden_pattern_catches_what_it_must():
    for line in ("import jax", "from jax import numpy", "import repro",
                 "import repro.core", "from repro.core import quant",
                 "from repro import configs", "  import jax.numpy as jnp"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import quant",
                 "import jaxlib_free_helper"):
        assert not FORBIDDEN.search(line), line


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, even on one
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    res = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    # alone in a directory, without the package, it fails too
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    res = _run_smoke(tmp_path, lone)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
