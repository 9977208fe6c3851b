"""A copy of the benchmark with a tiny configuration and tiny traffic mixes
added as files, for the CPU tests: what a later change adding a cell
does, at a size the CPU runs in seconds."""
from __future__ import annotations

import contextlib
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"name": "tiny", "hidden_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64,
        "intermediate_size": 256, "vocab_size": 512}
CLOSED = {"kind": "closed", "why": "tiny", "sessions": 4,
          "prompt": {"dist": "log_uniform", "lo": 32, "hi": 96, "round": 16},
          "max_new": "fill",
          "engine": {"capacity": 4, "s_max": 256, "paged": True,
                     "page_size": 16, "policy": "int4-srft",
                     "backend": "kernel", "chunk": 4},
          "warmup_steps": 1, "profile": {"steps": 2}}
# closed, every session ends after 48 tokens: the same tokens compared
# however fast the CPU runs
FIXED = dict(CLOSED, max_new={"dist": "fixed", "lo": 48, "hi": 48})
OPEN = {"kind": "open", "why": "tiny", "rate": 2.0, "block": 16,
        "prompt": {"dist": "log_uniform", "lo": 16, "hi": 64, "round": 1},
        "output": {"dist": "log_uniform", "lo": 4, "hi": 16, "round": 1},
        "engine": {"capacity": 4, "s_max": 128, "paged": True,
                   "page_size": 16, "policy": "int4-srft",
                   "backend": "kernel", "chunk": 4},
        "warmup_s": 1.0, "drain_s": 30.0,
        "profile": {"steps": 3}}


# the open cell's metrics: entries for the readers of open cells
OPEN_TOO = ("output_tok_s", "tpot_p95_ms", "kv_fill_share")
OPEN_END_TO_END = [{"name": "ttft_p90_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock"}]
OPEN_PER_LAYER = [
    {"name": "admit_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "batch scheduler",
     "moves": "ttft_p90_ms"},
    {"name": "step_mfu.open", "unit": "%", "better": "higher",
     "source": "program_span", "layer": "model step",
     "moves": "ttft_p90_ms"}]


def make_copy(dst: Path, *, limit: float = 1.0) -> Path:
    """``BENCHMARK.json`` and ``perfbench/`` copied to ``dst``, plus the
    tiny configuration, the mixes ``tiny-closed`` / ``tiny-fixed`` /
    ``tiny-open``, their cells and checks, each added as a file and an
    entry, and the open cell's metrics as entries."""
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cj = json.loads((ROOT / "perfbench/configs/qwen3-14b.json").read_text())
    cj.update(TINY)
    (dst / "perfbench/configs/tiny.json").write_text(json.dumps(cj))
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "perfbench/configs/tiny.json",
                            "reduced": [], "why": "test"})
    for name, mix in (("tiny-closed", CLOSED), ("tiny-fixed", FIXED),
                      ("tiny-open", OPEN)):
        (dst / f"perfbench/traffic/{name}.json").write_text(json.dumps(mix))
        (dst / f"perfbench/checks/{name}.json").write_text(json.dumps(
            {"sample": 2, "widest_gap": {"limit": limit}}))
        spec["workloads"].append({"name": name, "config": "tiny",
                                  "traffic": name, "chips": 1, "why": "t"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny-closed", "tiny-fixed"]
            if m["name"] in OPEN_TOO:
                m["workloads"].append("tiny-open")
    spec["end_to_end"] += [dict(m, workloads=["tiny-open"])
                           for m in OPEN_END_TO_END]
    spec["per_layer"] += [dict(m, workloads=["tiny-open"])
                          for m in OPEN_PER_LAYER]
    (dst / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dst


@contextlib.contextmanager
def fp32_compute():
    """The port's activations and matmuls in float32 (its own switches),
    so that it and the reference differ by rounding alone."""
    import torch
    from repro_torch.models import common

    saved = common.COMPUTE_DTYPE, common.BF16_DOTS
    common.COMPUTE_DTYPE, common.BF16_DOTS = torch.float32, False
    try:
        yield
    finally:
        common.COMPUTE_DTYPE, common.BF16_DOTS = saved


@contextlib.contextmanager
def bf16_compute():
    """The serving mode the benchmark runs: bf16 activations and operands."""
    from repro_torch.models import common

    saved = common.BF16_DOTS
    common.BF16_DOTS = True
    try:
        yield
    finally:
        common.BF16_DOTS = saved


def run(root: Path, workload: str, seed: int = 7, seconds: float = 2.0,
        trace: bool = False, **kw) -> dict:
    from perfbench import harness

    return harness.run_cell(root, workload, seed, seconds, trace,
                            device="cpu", log=lambda *a: None, **kw)
