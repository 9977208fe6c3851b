"""Readings for a cell's correctness limit (``checks/<cell>.json``), on
the card, in one process: the program's widest gap on each of
``--seeds`` seeds (its lower reading is the largest), and the fp8
control's on the first ``--control`` of them (its upper reading is the
smallest), each run at the cell's own load with a window of
``--seconds``.

    python perfbench/limits.py --workload <name> --seconds 10 \
        --seeds 12 --control 3 [--first-seed N]

Prints one JSON line per seed and a summary line.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_001)
    args = ap.parse_args(argv)
    os.environ["REPRO_BF16_DOTS"] = "1"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness

    lower, upper = [], []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, device="cuda",
                               control=i < args.control)
        prog = out["compared"]["widest_gap"]["value"]
        ctl = out.get("control", {}).get("widest_gap")
        lower.append(prog)
        if ctl is not None:
            upper.append(ctl)
        print(json.dumps({"seed": seed, "program": prog, "control": ctl,
                          "failed": out["failed"],
                          "attempted": out["attempted"],
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    print(json.dumps({"workload": args.workload, "lower": max(lower),
                      "upper": min(upper) if upper else None,
                      "program": lower, "control": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
