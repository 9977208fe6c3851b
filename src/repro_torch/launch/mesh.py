"""Device meshes (port of ``repro/launch/mesh.py``): a named grid of
``torch.device``s, ``make_mesh``, ``make_production_mesh``, ``data_axes``
and the card's data-sheet figures (``HW``).

The port is single-controller, as the reference is: one process holds
every shard and places each one on its mesh device (``launch/
partitioning.py``).  The device list may repeat a device.  That is the
simulated mesh, the counterpart of the reference's
``--xla_force_host_platform_device_count``: a ``(4, 2)`` mesh of ``cpu``
runs in one CPU process, and a ``(1, m)`` mesh of ``cuda:0`` splits the
KV heads m ways on one card.

    mesh = make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cuda:0"] * 2)
    mesh = make_mesh((1, 4), ("data", "model"))  # four visible cards

Functions, not module constants: importing this module touches no device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "data_axes",
           "visible_cards", "HW"]


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``; a bare ``cuda`` names the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device()
                         if torch.cuda.is_available() else 0)
    return d


class Mesh:
    """``devices``: an ndarray of ``torch.device`` shaped by the axes;
    ``shape``: axis name -> size, in axis order (as jax's mesh)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(devs.shape):
            devs[idx] = _device(np.asarray(devices, dtype=object)[idx])
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {tuple(axis_names)}")
        self.devices = devs
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The device at index 0 of every axis: where the single controller
        keeps what is replicated (params, token buffers, the scheduler's
        device state) and runs the full-width projections."""
        return self.devices.flat[0]

    def devices_along(self, axis: str) -> list:
        """The devices at index 0 of every other axis, one per index of
        ``axis`` (a shard of a leaf split over ``axis`` lives there)."""
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for j in range(self.devices.shape[i]):
            idx[i] = j
            out.append(self.devices[tuple(idx)])
        return out

    @property
    def cards(self) -> set:
        """The distinct devices of the grid."""
        return set(self.devices.flat)

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"Mesh({dims}; {sorted(map(str, self.cards))})"


def visible_cards() -> list:
    """One ``torch.device`` per visible CUDA card (none on a CPU host)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(dims: Sequence[int], names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``dims``-shaped mesh named ``names``.  ``devices`` defaults to the
    first ``prod(dims)`` visible cards and raises when there are fewer; a
    given list is taken as it is, repeats included (a simulated mesh)."""
    n = int(np.prod(dims))
    if devices is None:
        cards = visible_cards()
        if len(cards) < n:
            raise RuntimeError(
                f"a {tuple(dims)} mesh needs {n} devices and {len(cards)} "
                f"CUDA card(s) are visible; pass devices= (a list may "
                f"repeat a device: a simulated mesh)")
        devices = cards[:n]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"a {tuple(dims)} mesh takes {n} devices, got "
                         f"{len(devices)}")
    grid = np.empty((n,), dtype=object)
    grid[:] = [_device(d) for d in devices]
    return Mesh(grid.reshape(tuple(dims)), names)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The reference's production layout: ``(16, 16)`` over ('data',
    'model'), or ``(2, 16, 16)`` over ('pod', 'data', 'model')."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    have = len(visible_cards()) if devices is None else len(devices)
    if have < n:
        raise RuntimeError(
            f"the production mesh {shape} needs {n} devices; this host has "
            f"{have}")
    return make_mesh(shape, axes, None if devices is None
                     else list(devices)[:n])


def data_axes(mesh) -> tuple:
    """Batch-sharding axes: ('pod', 'data') when the pod axis exists."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


class HW:
    """NVIDIA H100 80GB HBM3 (SXM5), per card: NVIDIA's data-sheet values
    (dense rates, no sparsity), which assume the full 700 W power limit."""

    DATASHEET_HBM_BYTES_PER_S = 3.35e12
    DATASHEET_BF16_FLOP_PER_S = 989e12  # tensor cores, dense
    DATASHEET_FP32_FLOP_PER_S = 67e12  # outside the tensor cores
    DATASHEET_NVLINK_BYTES_PER_S = 900e9  # all links of one card
    DATASHEET_HBM_BYTES = 80e9
