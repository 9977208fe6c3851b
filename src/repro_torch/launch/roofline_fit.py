"""Depth-extrapolated roofline measurement (port of
``repro/launch/roofline_fit.py``).

The reference lowers each (arch x shape) cell at two reduced depths with
every scan unrolled, because XLA's ``cost_analysis()`` counts a while
loop's body once, and fits cost(u) = intercept + slope * u.  The port
counts the cell's step with the cost census (``launch/cost.py``) on a
model built on ``meta``: an eager loop over layers is seen once per layer,
so the fit at two depths equals the direct count at full depth (a test
holds it to that), and it costs two small censuses where a full-depth
census of the largest train cells takes tens of seconds.  An ssm train or
prefill cell is also counted at 2, 3 and 4 chunks of its length and
extrapolated (``dryrun.step_cost``).

Depth units per family (``depth_variants``, the reference's):
  dense/moe/vlm : u = layers                (fit at 2, 4)
  hybrid        : u = mamba+shared groups   (fit at P+rem, 2P+rem layers)
  ssm           : u = mLSTM/sLSTM groups    (fit at P, 2P layers)
  audio         : u = enc+dec layer pairs   (fit at 2, 4; enc==dec depth)

    PYTHONPATH=src python -m repro_torch.launch.roofline_fit --all
    PYTHONPATH=src python -m repro_torch.launch.roofline_fit \\
        --arch qwen3-14b --shape train_4k

Writes ``artifacts/roofline_torch/<arch>__<shape>__<suffix>.json``
(``single``, ``single_sp_fsdp`` under ``REPRO_SHARDING=sp_fsdp``, plus
``_bf16cache`` under ``REPRO_KV_CACHE=bf16``); resumable.  The record has
the reference's keys.  The step is not partitioned: ``chips`` is 1, and
the FLOPs, bytes and collective bytes are the whole step's on one device
(``collectives`` from ``roofline.collective_bytes``: the copies between
devices, under ``device-copy``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import (
    build_cell,
    cell_is_applicable,
    fit,
    step_cost,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model

__all__ = ["depth_variants", "meta_mesh", "measure_point", "linfit",
           "fit_cell", "run_cell", "main", "COLL_KINDS"]

COLL_KINDS = rl.COLLECTIVES + ("device-copy",)


def depth_variants(cfg):
    """[(reduced_cfg, u), ...], u_full for the linear depth fit."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return [(dataclasses.replace(cfg, n_layers=u), u) for u in (2, 4)], \
            cfg.n_layers
    if fam == "hybrid":
        P = cfg.shared_attn_period
        rem = cfg.n_layers % P
        pts = [(dataclasses.replace(cfg, n_layers=u * P + rem), u)
               for u in (1, 2)]
        return pts, cfg.n_layers // P
    if fam == "ssm":
        P = cfg.xlstm.slstm_period
        assert cfg.n_layers % P == 0
        pts = [(dataclasses.replace(cfg, n_layers=u * P), u) for u in (1, 2)]
        return pts, cfg.n_layers // P
    if fam == "audio":
        assert cfg.encoder_layers == cfg.n_layers, "audio fit assumes enc==dec"
        pts = [(dataclasses.replace(cfg, n_layers=u, encoder_layers=u), u)
               for u in (2, 4)]
        return pts, cfg.n_layers
    raise ValueError(fam)


def meta_mesh():
    """The single-pod production mesh of ``meta`` devices (the cells'
    specs are built on it; the census runs the step unpartitioned)."""
    return make_production_mesh(devices=["meta"] * 256)


def measure_point(arch, shape_name, mesh, cfg) -> dict:
    """The census of the cell's step with ``cfg`` on ``meta``
    (``dryrun.step_cost``)."""
    cell = build_cell(arch, shape_name, mesh, cfg=cfg)
    m = step_cost(cell, arch, shape_name, mesh)
    cost, coll = m["cost_analysis"], m["collectives"]
    return {"flops": cost["flops"], "bytes": cost["bytes accessed"],
            "coll": {k: float(coll[k]) for k in COLL_KINDS},
            "coll_total": float(coll["total"]),
            "coll_counts": coll["counts"]}


def linfit(p1, p2, u1, u2, u_full):
    """The line through (u1, p1) and (u2, p2) at ``u_full``, at least 0;
    on numbers or on records of the same keys (``dryrun.fit``)."""
    return fit([p1, p2], (u1, u2), u_full)


def fit_cell(arch: str, shape_name: str, cfg=None) -> dict:
    """The record of one cell, fitted at ``cfg``'s (default: the
    registry's) two reduced depths and extrapolated to its full depth."""
    cfg = cfg or get_config(arch)
    pol = os.environ.get("REPRO_SHARDING", "baseline")
    t0 = time.time()
    record = {"arch": arch, "shape": shape_name, "mesh": "single",
              "chips": 1, "method": "depth_fit_census", "sharding": pol}
    try:
        mesh = meta_mesh()
        pts, u_full = depth_variants(cfg)
        (c1, u1), (c2, u2) = pts
        m1 = measure_point(arch, shape_name, mesh, c1)
        m2 = measure_point(arch, shape_name, mesh, c2)
        record["points"] = [{"u": u1, **m1}, {"u": u2, **m2}]
        record["u_full"] = u_full
        fitted = linfit(m1, m2, u1, u2, u_full)
        del fitted["coll_counts"]
        record["fitted"] = fitted
        record["roofline"] = rl.roofline_terms(
            fitted["flops"], fitted["bytes"], fitted["coll_total"])
        # the model FLOPs of the full config (params on meta, nothing run)
        params = build_model(cfg, device="meta").init(torch.Generator())
        mf = rl.model_flops_estimate(cfg, SHAPES[shape_name], params)
        mf["useful_ratio"] = (mf["model_flops"] / fitted["flops"]
                              if fitted["flops"] else None)
        record["model_flops"] = mf
        record["status"] = "ok"
        record["t_total_s"] = round(time.time() - t0, 1)
        r = record["roofline"]
        print(f"[ok] {arch} x {shape_name}: flops {fitted['flops']:.3e} "
              f"bytes {fitted['bytes']:.3e} coll {fitted['coll_total']:.3e} "
              f"-> {r['bottleneck']} ({record['t_total_s']}s)")
    except Exception as e:
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch} x {shape_name}: {record['error']}")
    return record


def run_cell(arch, shape_name, out_dir="artifacts/roofline_torch"):
    os.makedirs(out_dir, exist_ok=True)
    pol = os.environ.get("REPRO_SHARDING", "baseline")
    suffix = "single" if pol == "baseline" else f"single_{pol}"
    if os.environ.get("REPRO_KV_CACHE", "int4") == "bf16":
        suffix += "_bf16cache"
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{suffix}.json")
    if os.path.exists(out_path):
        print(f"[skip] {out_path}")
        return
    ok, why = cell_is_applicable(arch, shape_name)
    record = (fit_cell(arch, shape_name) if ok else
              {"arch": arch, "shape": shape_name, "status": "skipped",
               "reason": why})
    with open(out_path, "w") as f:
        json.dump(record, f, indent=2, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/roofline_torch")
    args = ap.parse_args(argv)
    if args.all:
        for arch in ARCH_IDS:
            for shape_name in SHAPES:
                run_cell(arch, shape_name, args.out)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        run_cell(args.arch, args.shape, args.out)


if __name__ == "__main__":
    main()
