"""PyTorch/CUDA port of the int4 SRFT KV-cache system (reference: ``repro``).

Mirrors the JAX package's sub-paths (``configs``, ``core``, ``kernels``,
``models``, ``launch``); every module names the reference file it ports.
The package imports ``torch`` and never ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`resolve_device`); without a card and without that explicit
request they raise -- there is no silent CPU path.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is visible); anything
    else is taken as given, so CPU runs are always an explicit request."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "visible; pass device='cpu' to run the plain versions"
            )
        return torch.device("cuda")
    return torch.device(device)
