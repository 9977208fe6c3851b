"""The end-to-end arithmetic against hand counts: tails over every
sample of the window."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tinycell  # noqa: E402,F401

import types  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from perfbench import stats  # noqa: E402
from perfbench.harness import load_reader  # noqa: E402

BENCH = tinycell.ROOT / "perfbench"

# two streams; the window is (10, 20]
DELIVERIES = {
    1: [(9.0, 9), (11.0, 8), (13.0, 8), (21.0, 8)],
    2: [(12.0, 1), (12.5, 4), (20.0, 2)],
}


def test_percentile_is_linear_between_ranks():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(
        float(np.percentile(xs, 95)))
    assert stats.percentile([3.0], 90) == 3.0
    assert stats.percentile([], 90) is None
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5


def test_output_tokens_per_second_counts_the_window_only():
    # 8 + 8 (stream 1) + 1 + 4 + 2 (stream 2) over 10 s
    assert stats.output_tok_s(DELIVERIES, 10.0, 20.0) == pytest.approx(2.3)


def test_tpot_takes_every_delivery_but_a_streams_first():
    got = sorted(stats.tpot_samples(DELIVERIES, 10.0, 20.0))
    want = sorted([2.0 / 8, 2.0 / 8, 0.5 / 4, 7.5 / 2])
    assert got == pytest.approx(want)


def test_ttft_from_due_time_and_missing_requests():
    due = {1: 10.5, 2: 11.0, 3: 19.0, 4: 9.0, 5: 25.0}
    first = {1: 11.0, 2: 12.0, 4: 9.5}
    xs, missing = stats.ttft_samples(due, first, 10.0, 20.0)
    assert sorted(xs) == pytest.approx([0.5, 1.0])
    assert missing == 1


def _ctx(**kw):
    base = dict(t_open=10.0, t_close=20.0, deliveries=DELIVERIES,
                first={1: 9.0, 2: 12.0}, due={1: 8.0, 2: 11.0},
                memory_peak_bytes=3 * 2 ** 30, setup_s=4.5)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("name, want", [
    ("output_tok_s", 2.3),
    ("tpot_p95_ms", 1000 * float(np.percentile(
        [2.0 / 8, 2.0 / 8, 0.5 / 4, 7.5 / 2], 95))),
    ("ttft_p90_ms", 1000.0),
    ("peak_mem_gib", 3.0),
    ("setup_s", 4.5),
])
def test_end_to_end_readers(name, want):
    assert load_reader(BENCH, name)(_ctx()) == pytest.approx(want)


def test_span_readers_against_hand_counts():
    steps = [
        {"t0": 0, "t1": 1, "admitted": [5], "decoded": [(5, 0, 3)],
         "engine_step": {"t0": 0.0, "t1": 0.5},
         "decode_chunk": {"t0": 0.2, "t1": 0.5, "args": {"steps": 2}}},
        {"t0": 1, "t1": 2, "admitted": [], "decoded": [(5, 3, 2)],
         "engine_step": {"t0": 1.0, "t1": 1.25},
         "decode_chunk": {"t0": 1.0, "t1": 1.2, "args": {"steps": 2}}},
    ]

    class C:
        def span_steps(self):
            return steps

    ctx = C()
    assert load_reader(BENCH, "step_ms.long")(ctx) == pytest.approx(
        1000 * 0.5 / 4)
    assert load_reader(BENCH, "admit_ms")(ctx) == pytest.approx(
        1000 * (0.5 + 0.25 - 0.3 - 0.2) / 1)


def test_kv_fill_share_divides_by_the_whole_pool():
    # 4 live rows mapped to 32 of the pool's 100 usable pages of 16
    pool = {"n_pages": 100, "page_size": 16, "live_requests": 4,
            "pages_per_request": 8}
    ctx = types.SimpleNamespace(pool=pool, kv_tokens=400)
    assert load_reader(BENCH, "kv_fill_share")(ctx) == pytest.approx(25.0)
    assert load_reader(BENCH, "kv_fill_share")(
        types.SimpleNamespace(pool=None, kv_tokens=0)) is None
