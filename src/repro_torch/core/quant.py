"""Symmetric per-group quantization (port of ``repro/core/quant.py:50-97``).

q = clip(rint(x / scale), -qmax, qmax) with scale = max(absmax, 1e-12) /
qmax and qmax = 2^(b-1) - 1.  The division is a true division and the
rounding is half-to-even (``torch.round`` matches ``jnp.rint``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["qmax", "Quantized", "quantize_per_group", "dequantize_per_group"]

_EPS = 1e-12


def qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


class Quantized(NamedTuple):
    codes: torch.Tensor  # int8 codes in [-qmax, qmax], shape (..., d)
    scales: torch.Tensor  # fp32 scales, shape (..., d//group)
    bits: int


def quantize_per_group(x: torch.Tensor, bits: int, group: int) -> Quantized:
    """d/group scales per vector; codes keep shape (..., d)."""
    d = x.shape[-1]
    if d % group:
        raise ValueError(f"d={d} not divisible by group={group}")
    xg = x.float().reshape(*x.shape[:-1], d // group, group)
    absmax = xg.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(_EPS) / qmax(bits)
    m = qmax(bits)
    codes = torch.round(xg / scale).clamp(-m, m).to(torch.int8)
    return Quantized(codes.reshape(x.shape), scale[..., 0], bits)


def dequantize_per_group(q: Quantized, group: int) -> torch.Tensor:
    d = q.codes.shape[-1]
    cg = q.codes.float().reshape(*q.codes.shape[:-1], d // group, group)
    return (cg * q.scales[..., None]).reshape(q.codes.shape)
