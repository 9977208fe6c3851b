"""Carry the JAX package's parameters and rotations into the port.

Inputs are nested dicts of numpy arrays (the caller converts its pytrees
with ``np.asarray``), so this module imports neither ``jax`` nor
``repro``.  bf16 leaves arrive as numpy arrays of the ``bfloat16`` dtype
that JAX registers; ``torch.from_numpy`` refuses that dtype, so they cross
as ``uint16`` views and become ``torch.bfloat16`` by ``.view``: the bits
are unchanged.  ``dense`` weights keep the reference layout
``(d_in, *d_out)``, which is the port's layout too.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.calibrate import CalibParams
from repro_torch.core.transforms import Rotation

__all__ = ["to_torch", "lm_params", "rotation", "rotations", "calib_params"]


def to_torch(x: Any, device="cpu") -> Any:
    """numpy array (or a nested dict of them) -> tensors, bit-exact."""
    if isinstance(x, dict):
        return {k: to_torch(v, device) for k, v in x.items()}
    a = np.array(x)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def lm_params(tree: dict, device="cpu") -> dict:
    """A reference ``LM.init`` tree -> the port's params: the layer-stacked
    ``blocks`` leaves are split into one dict per layer."""
    out = {k: to_torch(v, device) for k, v in tree.items() if k != "blocks"}
    blocks = tree["blocks"]
    n_layers = len(np.asarray(blocks["ln_attn"]["scale"]))
    out["blocks"] = [to_torch(_layer(blocks, i), device)
                     for i in range(n_layers)]
    return out


def rotation(tree: dict, kind: str = "srft", device="cpu") -> Rotation:
    """One rotation ``{"matrix", "lam", "signs"}`` -> the port's."""
    return Rotation(matrix=to_torch(tree["matrix"], device),
                    lam=to_torch(tree["lam"], device),
                    signs=to_torch(tree["signs"], device), kind=kind)


def rotations(tree: dict, kind: str = "srft", device="cpu"
              ) -> list[tuple[Rotation, Rotation]]:
    """Layer-stacked rotations ``{"k": {"matrix", "lam", "signs"}, "v":
    {...}}`` (leaves (L, ...)) -> one (rot_k, rot_v) pair per layer."""
    def one(side, i):
        return rotation({k: np.asarray(v)[i] for k, v in tree[side].items()},
                        kind, device)

    n_layers = np.asarray(tree["k"]["matrix"]).shape[0]
    return [(one("k", i), one("v", i)) for i in range(n_layers)]


def calib_params(tree: Any, device="cpu"):
    """The reference's ``CalibParams`` (numpy leaves, ``None`` kept) -> the
    port's, field by field."""
    return CalibParams(*(None if getattr(tree, f) is None
                         else to_torch(getattr(tree, f), device)
                         for f in CalibParams._fields))
