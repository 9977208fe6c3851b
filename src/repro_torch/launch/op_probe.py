"""Op attribution probe (counterpart of ``repro/launch/hlo_probe.py``,
named apart because the port has no HLO): the cost census of one
reduced-depth cell on ``meta`` (``launch/cost.py``), its output bytes and
op counts by op kind, and the top-K single ops by output bytes with the
``repro_torch`` source line that ran each -- what the memory term is made
of, and where to fix it.

    PYTHONPATH=src python -m repro_torch.launch.op_probe --arch qwen3-14b \\
        --shape train_4k [--layers 2] [--top 25]

Dense, moe and vlm cells run ``--layers`` layers; the other families take
the structural reduction of ``roofline_fit.depth_variants`` (its first
point), as the reference's probe does.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses

from repro_torch.configs import get_config
from repro_torch.launch import cost as ca
from repro_torch.launch.dryrun import build_cell
from repro_torch.launch.roofline_fit import depth_variants, meta_mesh

__all__ = ["analyze", "report", "main"]


def analyze(records, top: int = 25):
    """(output bytes by op kind, op count by op kind, the ``top`` single
    ops by output bytes as (bytes, op, src)).  Records that move no byte
    (views, allocations) are left out."""
    per_op = collections.Counter()
    per_op_count = collections.Counter()
    lines = []
    for r in records:
        if not r.nbytes:
            continue
        per_op[r.op] += r.bytes_written
        per_op_count[r.op] += 1
        lines.append((r.bytes_written, r.op, r.src))
    lines.sort(key=lambda x: -x[0])
    return per_op, per_op_count, lines[:top]


def report(records, top: int = 25, kinds: int = 18) -> list[str]:
    """The probe's printed lines for a census."""
    cost = ca.summarize(records)
    per_op, per_cnt, top_lines = analyze(records, top)
    out = [f"cost_analysis: flops={cost['flops']:.4g} "
           f"bytes={cost['bytes accessed']:.4g} "
           f"transcendentals={cost['transcendentals']:.4g}",
           f"-- OUTPUT bytes by op kind (total {sum(per_op.values()):.3g}) --"]
    out += [f"  {op:28s} {b:.3e}  ({per_cnt[op]} ops)"
            for op, b in per_op.most_common(kinds)]
    out.append(f"-- top {top} single ops by output bytes --")
    out += [f"  {b:.3e}  {op:28s} {src}" for b, op, src in top_lines]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family in ("dense", "moe", "vlm"):
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    else:  # structural reductions per family (same rules as roofline_fit)
        cfg = depth_variants(cfg)[0][0][0]
    cell = build_cell(args.arch, args.shape, meta_mesh(), cfg=cfg)
    _, records = ca.cost_analysis(cell.fn, *cell.args)
    for line in report(records, args.top):
        print(line)


if __name__ == "__main__":
    main()
