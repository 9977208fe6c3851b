"""Pipeline parallelism: a GPipe microbatched schedule over one mesh axis
(port of ``repro/distributed/pipeline.py``).

Stage s owns layers ``[s*L/S, (s+1)*L/S)`` and lives on the device at
index s of ``axis`` (``Mesh.devices_along``).  Microbatches stream
through: at step t, stage s runs microbatch t - s, and its output hops to
stage s + 1 for step t + 1.  The bubble is (S - 1) / (M + S - 1) of the
steps.  The reference runs the stages as one ``shard_map`` program with
``ppermute`` hops; the port is single-controller, as its mesh is: one
process walks the same schedule, each stage's layers run on its device,
and an activation hops with ``.to(device)``.  On a mesh whose stages
share one device the stages run one after another.

Scope, as the reference's: the forward pipeline (inference, activation
streaming) for depth-dominated serving layouts; training shards the layer
stack instead.

    out = pipeline_forward(layer_fn, blocks, x, mesh=mesh, axis="pod",
                           n_layers=8)

Each microbatch takes the layers in order with the same ``layer_fn`` on
the same shapes, so the result equals a sequential loop over each
microbatch bit for bit (a loop over the whole batch at once runs its
products at another row count).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["pipeline_forward"]


def _layer(stacked: Any, i: int):
    """Layer i of a tree whose leaves lead with the layer axis, or item i
    of a per-layer list (the port's layout of ``params["blocks"]``)."""
    if isinstance(stacked, list):
        return stacked[i]
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    if isinstance(stacked, tuple):
        return tuple(_layer(v, i) for v in stacked)
    return stacked[i]


def _to(tree: Any, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def pipeline_forward(layer_fn: Callable, stacked_params, x: torch.Tensor, *,
                     mesh, axis: str = "pod", n_layers: int) -> torch.Tensor:
    """``layer_fn(params_i, h) -> h`` over ``n_layers`` split across the
    ``axis`` dimension of ``mesh``, GPipe schedule.  ``stacked_params``:
    a tree whose leaves lead with n_layers, or a per-layer list.  ``x``:
    (n_micro, micro_batch, ...).  Returns the (n_micro, micro_batch, ...)
    output on ``x``'s device."""
    devices = mesh.devices_along(axis)
    n_stages = len(devices)
    if n_layers % n_stages:
        raise ValueError(f"n_layers={n_layers} does not split into "
                         f"{n_stages} stages")
    per_stage = n_layers // n_stages
    stages = [[_to(_layer(stacked_params, s * per_stage + i), dev)
               for i in range(per_stage)]
              for s, dev in enumerate(devices)]
    n_micro = x.shape[0]
    out = torch.empty_like(x)
    inbox: list = [None] * n_stages  # what arrived for each stage
    for t in range(n_micro + n_stages - 1):
        sent: list = [None] * n_stages
        for s in range(n_stages):
            mb = t - s
            if not 0 <= mb < n_micro:
                continue
            h = x[mb].to(devices[s]) if s == 0 else inbox[s]
            for p in stages[s]:
                h = layer_fn(p, h)
            if s == n_stages - 1:
                out[mb] = h.to(out.device)
            else:
                sent[s + 1] = h.to(devices[s + 1])  # the hop to s + 1
        inbox = sent
    return out
