"""A configuration, a traffic mix, a check and a per-layer metric added as
files (and entries) to a copy of the benchmark are found by name."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tinycell  # noqa: E402

import json  # noqa: E402

from perfbench import harness  # noqa: E402


def test_added_files_are_found_by_name(tmp_path):
    root = tinycell.make_copy(tmp_path)
    (root / "perfbench/metrics/streams_live.py").write_text(
        "def read(ctx):\n    return float(len(ctx.first))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "streams_live", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "batch scheduler",
        "moves": "output_tok_s", "workloads": ["tiny-closed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve(root, "tiny-closed")
    assert cell.config["hidden_size"] == 128
    assert cell.traffic["sessions"] == 4
    assert cell.check["sample"] == 2
    assert "streams_live" in [m["name"] for m in cell.per_layer]
    assert "ttft_p90_ms" not in [m["name"] for m in cell.end_to_end]
    assert "ttft_p90_ms" in [
        m["name"] for m in harness.resolve(root, "tiny-open").end_to_end]
    out = tinycell.run(root, "tiny-closed", trace=True)
    assert out["metrics"]["streams_live"]["value"] == 4.0
    assert set(out["metrics"]) >= {"step_ms.long", "decode_mfu.long",
                                   "kv_fill_share"}
    assert 0 < out["metrics"]["kv_fill_share"]["value"] <= 100
    out = tinycell.run(root, "tiny-closed")
    assert set(out["metrics"]) == {"output_tok_s", "tpot_p95_ms",
                                   "setup_s"}  # no peak memory on the CPU
    assert list(out)[-1] == "compared"


def test_open_cell_reports_its_metrics(tmp_path):
    root = tinycell.make_copy(tmp_path)
    out = tinycell.run(root, "tiny-open", seconds=3.0)
    assert set(out["metrics"]) == {"output_tok_s", "tpot_p95_ms",
                                   "ttft_p90_ms", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    out = tinycell.run(root, "tiny-open", seconds=3.0, trace=True)
    assert {"admit_ms", "step_mfu.open", "kv_fill_share"} <= set(
        out["metrics"])
    assert 0 < out["metrics"]["kv_fill_share"]["value"] <= 100
