"""Static per-channel lambda, the deployment calibration (port of
``repro/core/calibrate.py:44-58``; paper §7.1): one forward pass,
lambda_d = 1 / max over the window of |SRFT(x)|_d.  The learned variants
(Cayley, Householder, straight-through Adam on reconstruction MSE) are
not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.transforms import Rotation

__all__ = ["static_lambda", "apply_static_lambda"]


def static_lambda(rot: Rotation, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """lambda (d,) = 1 / per-channel max |base(x)| over every vector of x.

    Window-uniform: the max runs over the whole calibration window (§7.3:
    a wider window sees larger outliers, so a smaller lambda)."""
    base = Rotation(rot.matrix, torch.ones_like(rot.lam), rot.signs, rot.kind)
    y = base.forward(x.reshape(-1, x.shape[-1]))
    return 1.0 / y.abs().amax(dim=0).clamp_min(eps)


def apply_static_lambda(rot: Rotation, lam: torch.Tensor) -> Rotation:
    return Rotation(rot.matrix, lam.float(), rot.signs, rot.kind)
