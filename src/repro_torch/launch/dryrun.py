"""Dry run of every (arch x shape) cell on the production mesh, on the
``meta`` device: nothing is allocated and nothing runs (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

Writes one JSON per cell to ``artifacts/dryrun_torch/``; cells already
present are skipped (resumable).  A CPU-only machine runs it.

A cell is built as the reference builds it: the model and its params on
``meta`` (``build_model(cfg, device="meta")``), the step the cell runs
(``make_train_step`` / ``make_prefill_step`` / ``make_decode_step``) and
its arguments, each placed by the reference's rules on
``make_production_mesh(devices=["meta"] * n)``: params (and for a train
cell the Adam state) by ``param_specs`` (``REPRO_SHARDING=sp_fsdp``
selects the FSDP layout), the batch by ``batch_specs``, the cache by
``cache_specs``.  The record holds each argument's bytes per device (a
leaf's bytes over the pieces its spec cuts it into) -- the counterpart of
the reference's ``memory_analysis`` argument bytes -- the mesh and the
status, and, from the cost census of the cell's step run once at full
depth on ``meta`` (``launch/cost.py``; the int4 cache's kernels through
their wrappers' ``meta`` branch): ``cost_analysis`` (``flops``, ``bytes
accessed``, ``transcendentals``), ``collectives``
(``roofline.collective_bytes``), ``roofline`` and ``model_flops`` with
its ``useful_ratio``.  An ssm train or prefill cell steps its recurrent
blocks a chunk at a time through the whole length, millions of eager ops
(hours on ``meta``): it is counted at 2, 3 and 4 chunks and
extrapolated (``step_cost``; ``cost_method`` says which).  The step is
not partitioned: these count the whole step on one device, where the
reference's count one device's shard.

The reference also records the HLO's size and the lower / compile
seconds.  The port compiles no whole-program module, so those fields are
left out, and the record's ``not_recorded`` says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, LONG_CONTEXT_ARCHS, SHAPES, get_config
from repro_torch.launch import cost as ca
from repro_torch.launch import partitioning as pt
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs, serve_cache_shapes
from repro_torch.launch.steps import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import build_model
from repro_torch.optim.adam import adam_init

__all__ = ["cell_is_applicable", "build_cell", "run_cell", "step_cost",
           "per_token_loop", "fit", "per_device_bytes", "main",
           "NOT_RECORDED"]

NOT_RECORDED = {
    "fields": ["hlo_bytes", "t_lower_s", "t_compile_s"],
    "reason": "the reference reads them from XLA's compiled module; the "
              "port compiles no whole-program module",
    "note": "the port's step is not partitioned: cost_analysis, "
            "collectives and roofline count the whole step on one device, "
            "not one device's shard, and useful_ratio divides the model "
            "FLOPs by the step's",
}


@dataclasses.dataclass
class Cell:
    """A built cell: the step, its ``meta`` arguments and their specs
    (layer-stacked, as the rules read them), the config, the shape and
    the params."""

    fn: Callable
    args: tuple
    specs: dict  # argument name -> (stacked tree, spec tree)
    cfg: Any
    shape: Any
    params: Any


def cell_is_applicable(arch: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, (
            "long_500k needs a sub-quadratic backbone; skipped for pure "
            "full-attention archs (DESIGN.md §3)")
    return True, ""


def _layout() -> str:
    return ("sp_fsdp" if os.environ.get("REPRO_SHARDING") == "sp_fsdp"
            else "baseline")


def _placed(tree, spec_fn, mesh):
    """(layer-stacked shapes, their spec tree) of a port tree."""
    shapes = pt.stacked_view(tree)
    return shapes, spec_fn(shapes, mesh)


def build_cell(arch: str, shape_name: str, mesh, cfg=None,
               shape=None) -> Cell:
    """The cell's step and ``meta`` arguments with their specs on
    ``mesh``; ``cfg`` and ``shape`` override the registry's."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    model = build_model(cfg, device="meta")
    params = model.init(torch.Generator())
    layout = _layout()
    specs = {"params": _placed(
        params, lambda t, m: pt.param_specs(t, m, layout=layout), mesh)}

    if shape.kind == "train":
        opt = adam_init(params)
        specs["opt_state"] = _placed(
            {"mu": opt.mu, "nu": opt.nu},
            lambda t, m: pt.param_specs(t, m, layout=layout), mesh)
        batch = input_specs(cfg, shape)
        specs["batch"] = _placed(batch, pt.batch_specs, mesh)
        return Cell(make_train_step(model), (params, opt, batch), specs, cfg,
                    shape, params)

    # serving cells: the rotations ride inside the cache
    cache = serve_cache_shapes(model, cfg, shape)
    specs["cache"] = _placed(cache, pt.cache_specs, mesh)
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        specs["batch"] = _placed(batch, pt.batch_specs, mesh)
        return Cell(make_prefill_step(model), (params, batch, cache), specs,
                    cfg, shape, params)
    token = input_specs(cfg, shape)["token"]
    specs["batch"] = _placed({"t": token}, pt.batch_specs, mesh)
    return Cell(make_decode_step(model), (params, token, cache), specs, cfg,
                shape, params)


def per_token_loop(cfg, shape) -> bool:
    """An ssm train or prefill cell: its mLSTM / sLSTM blocks step through
    the whole length a chunk at a time, millions of eager ops at the
    cell's length."""
    return cfg.family == "ssm" and shape.kind != "decode"


def fit(points, xs, x):
    """The polynomial through ``(xs[i], points[i])`` at ``x`` (a line
    through two points, the reference's ``linfit``; a parabola through
    three), leaf by leaf of records with the same keys, at least 0."""
    if isinstance(points[0], dict):
        return {k: fit([p[k] for p in points], xs, x) for k in points[0]}
    total = 0.0
    for i, (xi, yi) in enumerate(zip(xs, points)):
        w = 1.0
        for j, xj in enumerate(xs):
            if j != i:
                w *= (x - xj) / (xi - xj)
        total += w * yi
    return max(0.0, total)


def _census(cell: Cell) -> dict:
    cost, records = ca.cost_analysis(cell.fn, *cell.args)
    return {"cost_analysis": cost,
            "collectives": rl.collective_bytes(records)}


def step_cost(cell: Cell, arch: str, shape_name: str, mesh) -> dict:
    """``{"cost_analysis", "collectives"}`` of the cell's step: its cost
    census on ``meta``.  A per-token-loop cell (:func:`per_token_loop`) is
    counted at 2, 3 and 4 chunks of its length and the parabola through
    them taken at the cell's: every chunk runs the same ops, so a
    prefill's counts are linear in the chunks, and a train step's are
    quadratic, since the backward of each chunk's slice of its input
    (``select_backward`` / ``slice_backward``) writes a gradient of the
    whole length and the chunks' gradients are summed (a test holds the
    fit to a direct count)."""
    if not per_token_loop(cell.cfg, cell.shape):
        return _census(cell)
    c = cell.cfg.xlstm.chunk
    ns = (2, 3, 4)
    points = [_census(build_cell(arch, shape_name, mesh, cfg=cell.cfg,
                                 shape=dataclasses.replace(cell.shape,
                                                           seq_len=n * c)))
              for n in ns]
    return fit(points, ns, cell.shape.seq_len / c)


def _pieces(spec, mesh) -> int:
    n = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                n *= mesh.shape[a]
    return n


def per_device_bytes(shapes, specs, mesh) -> int:
    """Bytes one device holds of a tree placed by ``specs``: each leaf's
    bytes over the pieces its spec cuts it into (the rules only cut a dim
    its axes divide)."""
    spec_of = dict(pt.flatten_with_path(specs))
    total = 0
    for path, leaf in pt.flatten_with_path(shapes):
        nbytes = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        total += nbytes // _pieces(spec_of.get(path, pt.P()), mesh)
    return total


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    if os.path.exists(out_path):
        print(f"[skip] {out_path} exists")
        return
    ok, why = cell_is_applicable(arch, shape_name)
    if not ok:
        with open(out_path, "w") as f:
            json.dump({"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                       "status": "skipped", "reason": why}, f, indent=2)
        print(f"[skip-cell] {arch} x {shape_name}: {why}")
        return

    multi = mesh_kind == "multi"
    n = 512 if multi else 256
    mesh = make_production_mesh(multi_pod=multi, devices=["meta"] * n)
    n_chips = int(np.prod(list(mesh.shape.values())))
    t0 = time.time()
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "mesh_shape": dict(mesh.shape), "chips": n_chips,
              "device": "meta", "layout": _layout()}
    try:
        cell = build_cell(arch, shape_name, mesh)
        per = {name: per_device_bytes(shapes, specs, mesh)
               for name, (shapes, specs) in cell.specs.items()}
        per["total"] = sum(per.values())
        record["argument_bytes_per_device"] = per
        record["t_build_s"] = round(time.time() - t0, 2)
        record.update(step_cost(cell, arch, shape_name, mesh))
        record["cost_method"] = (
            "census at 2, 3 and 4 chunks of the length, extrapolated"
            if per_token_loop(cell.cfg, cell.shape) else "census")
        cost = record["cost_analysis"]
        flops = cost["flops"]
        record["roofline"] = rl.roofline_terms(
            flops, cost["bytes accessed"], record["collectives"]["total"])
        mf = rl.model_flops_estimate(cell.cfg, cell.shape, cell.params)
        mf["useful_ratio"] = mf["model_flops"] / flops if flops else None
        record["model_flops"] = mf
        record["not_recorded"] = NOT_RECORDED
        record["status"] = "ok"
        record["t_census_s"] = round(time.time() - t0 - record["t_build_s"],
                                     2)
        print(f"[ok] {arch} x {shape_name} x {mesh_kind}: argument bytes "
              f"per device {per['total']:.3e}, flops {flops:.3e} bytes "
              f"{cost['bytes accessed']:.3e} (census "
              f"{record['t_census_s']}s), model flops "
              f"{mf['model_flops']:.3e}")
    except Exception as e:
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch} x {shape_name} x {mesh_kind}: {record['error']}")
    with open(out_path, "w") as f:
        json.dump(record, f, indent=2, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    if args.all:
        for arch in ARCH_IDS:
            for shape_name in SHAPES:
                run_cell(arch, shape_name, args.mesh, args.out)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        run_cell(args.arch, args.shape, args.mesh, args.out)


if __name__ == "__main__":
    main()
