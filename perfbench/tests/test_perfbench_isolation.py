"""What the harness and the reference load: no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (compared whole, so
``repro_torch`` is not ``repro``), and the reference nothing of
``repro_torch``.  ``run.py`` prints no result without a card, or in a
checkout that holds only the benchmark."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tinycell  # noqa: E402

import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402

from perfbench import harness  # noqa: E402

ROOT = tinycell.ROOT
IMPORT = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w]*)", re.M)


def _py(code: str, cwd=None, env=None):
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_sources_import_no_forbidden_package():
    files = [f for f in (ROOT / "perfbench").rglob("*.py")
             if "tests" not in f.parts]
    assert len(files) > 20
    for f in files:
        tops = set(IMPORT.findall(f.read_text()))
        assert not tops & set(harness.FORBIDDEN), f
        if "reference" in f.parts:
            assert not {t for t in tops if t.startswith("repro")}, f


def test_reference_loads_nothing_of_the_port():
    r = _py("import sys\n"
            "import perfbench.reference.model, perfbench.reference.compare\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert r.returncode == 0, r.stderr
    tops = json.loads(r.stdout.replace("'", '"'))
    assert not [t for t in tops if t.startswith("repro")], tops
    assert not set(tops) & {"jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax_and_no_repro(tmp_path):
    root = tinycell.make_copy(tmp_path)
    code = (
        "import sys, json\n"
        "from pathlib import Path\n"
        "from perfbench import harness\n"
        f"out = harness.run_cell(Path({str(root)!r}), 'tiny-closed', 5, 1.0,"
        " False, device='cpu', log=lambda *a: None)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps({'bad': harness.forbidden_modules(),"
        " 'port': 'repro_torch' in tops, 'correct': out['correct']}))\n")
    r = _py(code)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "port": True, "correct": True}


def test_run_refuses_without_a_card():
    r = subprocess.run(
        [sys.executable, str(ROOT / "perfbench/run.py"), "--workload",
         "internlm2-longctx-decode", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_run_refuses_in_a_bare_benchmark_checkout(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "internlm2-longctx-decode", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env=env, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
