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

__all__ = ["to_torch", "lm_params", "rotation", "rotations",
           "encdec_rotations", "calib_params"]


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


def _n_stacked(tree: Any) -> int:
    """The leading (stacked) axis of a tree's leaves."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def _unstack(tree: dict, depth: int, device) -> list:
    """Leaves stacked over ``depth`` leading axes -> nested per-layer
    lists of dicts (``depth`` 2: (n_super, P, ...) -> lists of lists)."""
    n = _n_stacked(tree)
    if depth == 1:
        return [to_torch(_layer(tree, i), device) for i in range(n)]
    return [_unstack(_layer(tree, i), depth - 1, device) for i in range(n)]


# the layer-stacked subtrees of the reference's trees and their depth:
# ``blocks`` (dense, moe, vlm), the hybrid's ``mamba_super`` (n_super, P)
# and ``mamba_rem``, the ssm's ``mlstm_super`` (n_super, P - 1) and
# ``slstm``, the encoder-decoder's ``enc_layers`` and ``dec_layers``; any
# other subtree (``shared_attn``, the embeddings, the finals) is one copy
_STACKED = {"blocks": 1, "mamba_super": 2, "mamba_rem": 1, "mlstm_super": 2,
            "slstm": 1, "enc_layers": 1, "dec_layers": 1}


def lm_params(tree: dict, device="cpu") -> dict:
    """A reference ``LM.init`` or ``EncDec.init`` tree -> the port's
    params: each layer-stacked subtree is split into per-layer dicts
    (nested lists for the hybrid's and the ssm's groups)."""
    return {k: (_unstack(v, _STACKED[k], device) if k in _STACKED
                else to_torch(v, device)) for k, v in tree.items()}


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


def encdec_rotations(tree: dict, kind: str = "srft", device="cpu"):
    """The reference's ``EncDecRotations`` as ``{"self_kv": {"k", "v"},
    "cross_kv": {"k", "v"}}`` of numpy leaves -> the port's."""
    from repro_torch.models.encdec import EncDecRotations

    return EncDecRotations(self_kv=rotations(tree["self_kv"], kind, device),
                           cross_kv=rotations(tree["cross_kv"], kind, device))


def calib_params(tree: Any, device="cpu"):
    """The reference's ``CalibParams`` (numpy leaves, ``None`` kept) -> the
    port's, field by field."""
    return CalibParams(*(None if getattr(tree, f) is None
                         else to_torch(getattr(tree, f), device)
                         for f in CalibParams._fields))
