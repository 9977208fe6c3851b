"""Run one benchmark cell of the PyTorch/CUDA port on one card.

    python perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result: {"correct", "attempted", "failed", "metrics", "device",
["breakdown",] "compared"}; ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics.  The numbers the check
compared, each beside its limit, are also the last lines of standard
error.  Without a CUDA card (or with fewer than the cell needs), or when
``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded once the window has
closed, it exits non-zero and prints no result.

Kernels build with nvcc into ``build/`` in the checkout on first use and
are reused from there; nothing else is cached.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the port's bf16 serving mode: matmuls on bf16 operands (read at
    # import); keep libraries that look for JAX from loading it
    os.environ["REPRO_BF16_DOTS"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from perfbench import harness

    cell = harness.resolve(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
