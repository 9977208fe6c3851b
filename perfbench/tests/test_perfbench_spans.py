"""``span_report`` on the tiny closed cell on the CPU: the readings of the
engine's host and device spans over the window and set-up."""
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tinycell  # noqa: E402

from perfbench import span_report  # noqa: E402


def test_span_report_reads_the_window_and_setup(tmp_path):
    root = tinycell.make_copy(tmp_path)
    rep = span_report.report(root, "tiny-closed", 2 ** 33 + 5, 2.0,
                             device="cpu")
    assert rep["result"]["correct"]
    assert {"step_ms.long", "decode_mfu.long"} <= set(
        rep["result"]["metrics"])
    assert rep["chunks"] > 0 and rep["decode_steps"] >= rep["chunks"]
    for key in ("chunk_gap_ms", "chunk_dev_ms", "turn_host_ms",
                "between_steps_ms", "prefill_mfu"):
        assert math.isfinite(rep[key]) and rep[key] >= 0, key
    per = rep["per_step_ms"]
    assert per["engine.step"] >= per["decode.chunk"] >= per["decode.enqueue"]
    assert rep["turn_host_ms"] < per["engine.step"]
    split = rep["setup_split"]
    assert rep["prefills"] == 4
    assert 0 < split["prefill_device_s"] < split["setup_s"]
    assert split["graph_capture_s"] is None  # no graph on the CPU
    # the CPU profiles no device: the stretch has no gap and no boundary
    assert rep["stretch"]["boundaries"] == []
