"""Plain PyTorch versions of kernels B3 and B4 (port of
``repro/kernels/srft_quant/ref.py``).

B3, ``srft_quant_ref`` (ref ``:37``):
    y      = x @ M.T          (fp32)
    y      = y * lam          (optional epilogue)
    scale  = max(absmax_per_group(y), 1e-12) / (2^(b-1) - 1)
    codes  = clip(rint(y / scale))
    packed = nibble-pack (int4) or int8 bytes
B4, ``srft_dequant_ref`` (ref ``:50``), its inverse:
    y      = unpack(codes) * scale
    x      = y @ Minv.T       (Minv = B.T @ diag(1/lam), fold_inverse_matrix)

``M`` may be the folded ``diag(lam)·R·B`` of :func:`fold_matrix` with
``lam=None`` (the reference kernel's signature), or the unfolded ``R·B``
with ``lam`` applied after the product: that is the order the cache
write uses (``Rotation.forward``), so it writes the reference cache's
exact bytes.  ``M=None`` skips the rotation (already-rotated input).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import packing, quant

__all__ = ["srft_quant_ref", "srft_dequant_ref", "fold_matrix",
           "fold_inverse_matrix"]


def fold_matrix(rotation) -> torch.Tensor:
    """(d, d) forward matrix with lambda folded: x @ M.T == rot.forward(x)
    up to rounding (the fold moves the lambda multiply into the sum)."""
    return rotation.matrix * rotation.lam[:, None]


def fold_inverse_matrix(rotation) -> torch.Tensor:
    """(d, d) matrix Minv with ``srft_dequant_ref(...) == rot.inverse(y)``
    up to rounding: Minv[d, e] = B[e, d] / max(lam[e], 1e-6)."""
    lam = rotation.lam.clamp_min(1e-6)
    return (rotation.matrix / lam[:, None]).T.contiguous()


def srft_quant_ref(x: torch.Tensor, m: Optional[torch.Tensor],
                   lam: Optional[torch.Tensor] = None, *, group: int,
                   bits: int = 4):
    """x (N, d), m (d, d) or None, lam (d,) or None -> (packed, scales).

    packed: (N, d//2) uint8 for int4, (N, d) int8 for int8;
    scales: (N, d//group) fp32.
    """
    y = x.float() if m is None else x.float() @ m.float().T
    if lam is not None:
        y = y * lam
    q = quant.quantize_per_group(y, bits, group)
    if bits == 4:
        return packing.pack_int4(q.codes), q.scales
    return q.codes, q.scales


def srft_dequant_ref(packed: torch.Tensor, scales: torch.Tensor,
                     minv: torch.Tensor, *, group: int, bits: int = 4
                     ) -> torch.Tensor:
    """Inverse of :func:`srft_quant_ref`: (packed, scales) -> x (N, d) fp32."""
    codes = packing.unpack_int4(packed) if bits == 4 else packed
    y = quant.dequantize_per_group(quant.Quantized(codes, scales, bits), group)
    return y @ minv.float().T
