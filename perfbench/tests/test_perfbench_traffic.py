"""The traffic generator is deterministic by seed, and seeds change the
order of the work, not its amount."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tinycell  # noqa: E402,F401

import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from perfbench import traffic  # noqa: E402

MIXES = {n: json.loads((tinycell.ROOT / f"perfbench/traffic/{n}.json")
                       .read_text())
         for n in ("longctx-64", "longctx-32")}
MIXES["tiny-open"] = tinycell.OPEN


def _key(reqs):
    return [(r.rid, r.prompt.tolist(), r.max_new, r.due) for r in reqs]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_seed_same_requests(name):
    mix = MIXES[name]
    s_max = mix["engine"]["s_max"]
    a = traffic.make_requests(mix, 1000, 2 ** 33 + 5, s_max=s_max,
                              seconds=5)
    b = traffic.make_requests(mix, 1000, 2 ** 33 + 5, s_max=s_max,
                              seconds=5)
    assert _key(a) == _key(b)
    c = traffic.make_requests(mix, 1000, 2 ** 33 + 6, s_max=s_max,
                              seconds=5)
    assert _key(a) != _key(c)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_seeds_share_sizes_and_gaps(name):
    mix = MIXES[name]
    s_max = mix["engine"]["s_max"]
    runs = [traffic.make_requests(mix, 1000, seed, s_max=s_max, seconds=5)
            for seed in (1, 2 ** 31 + 11, 4_000_000_001)]
    for reqs in runs:
        assert all(r.prompt.shape[0] + r.max_new <= s_max for r in reqs)
        assert all(0 <= r.prompt.min() and r.prompt.max() < 1000
                   for r in reqs)
    block = mix.get("block", len(runs[0]))
    for field in ("plen", "new", "gap"):
        sets = []
        for reqs in runs:
            if field == "plen":
                xs = [r.prompt.shape[0] for r in reqs]
            elif field == "new":
                xs = [r.max_new for r in reqs]
            else:
                if reqs[0].due is None:
                    continue
                d = [r.due for r in reqs]
                xs = np.round(np.diff([0.0] + d), 9).tolist()
            # every whole block holds the same values
            n = len(xs) // block * block
            sets.append(sorted(xs[:n]))
        assert all(s == sets[0] for s in sets), field


def test_first_requests_do_not_depend_on_the_horizon():
    mix = MIXES["tiny-open"]
    a = traffic.make_requests(mix, 1000, 9, s_max=128, seconds=5)
    b = traffic.make_requests(mix, 1000, 9, s_max=128, seconds=40)
    assert len(b) > len(a)
    assert _key(a) == _key(b[:len(a)])


def test_quantiles_are_stratified_log_uniform():
    q = traffic.quantiles({"dist": "log_uniform", "lo": 2048, "hi": 8192,
                           "round": 16}, 64)
    assert q.min() >= 2048 and q.max() <= 8192
    assert (q % 16 == 0).all() and (np.diff(q) >= 0).all()
    assert abs(np.median(np.log(q)) - np.log(4096)) < 0.05
