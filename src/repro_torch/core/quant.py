"""Symmetric uniform quantization schemes for KV vectors (port of
``repro/core/quant.py:50-124``): per token, per tensor, per group.

q = clip(rint(x / scale), -qmax, qmax) with scale = max(absmax, 1e-12) /
qmax and qmax = 2^(b-1) - 1.  The division is a true division and the
rounding is half-to-even (``torch.round`` matches ``jnp.rint``).
Per-channel scaling is the rotation's lambda, applied before these run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["qmax", "Quantized", "quantize_per_token", "dequantize_per_token",
           "quantize_per_tensor", "dequantize_per_tensor",
           "quantize_per_group", "dequantize_per_group", "quantize",
           "dequantize"]

_EPS = 1e-12


def qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


class Quantized(NamedTuple):
    codes: torch.Tensor  # int8 codes in [-qmax, qmax], shape (..., d)
    scales: torch.Tensor  # fp32; (..., 1), () or, per group, (..., d//group)
    bits: int


def _quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    m = qmax(bits)
    return torch.round(x.float() / scale).clamp(-m, m).to(torch.int8)


def quantize_per_token(x: torch.Tensor, bits: int) -> Quantized:
    """One scale per trailing-dim vector: scales (..., 1)."""
    absmax = x.float().abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(_EPS) / qmax(bits)
    return Quantized(_quantize(x, scale, bits), scale, bits)


def dequantize_per_token(q: Quantized) -> torch.Tensor:
    return q.codes.float() * q.scales


def quantize_per_tensor(x: torch.Tensor, bits: int) -> Quantized:
    """One scale for the whole tensor: scales ()."""
    scale = x.float().abs().amax().clamp_min(_EPS) / qmax(bits)
    return Quantized(_quantize(x, scale, bits), scale, bits)


dequantize_per_tensor = dequantize_per_token


def quantize_per_group(x: torch.Tensor, bits: int, group: int) -> Quantized:
    """d/group scales per vector; codes keep shape (..., d)."""
    d = x.shape[-1]
    if d % group:
        raise ValueError(f"d={d} not divisible by group={group}")
    xg = x.float().reshape(*x.shape[:-1], d // group, group)
    absmax = xg.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(_EPS) / qmax(bits)
    codes = _quantize(xg, scale, bits)
    return Quantized(codes.reshape(x.shape), scale[..., 0], bits)


def dequantize_per_group(q: Quantized, group: int) -> torch.Tensor:
    d = q.codes.shape[-1]
    cg = q.codes.float().reshape(*q.codes.shape[:-1], d // group, group)
    return (cg * q.scales[..., None]).reshape(q.codes.shape)


def quantize(x: torch.Tensor, bits: int, scheme: str, group: int = 32
             ) -> Quantized:
    """Scheme registry (ref ``quant.py:106``)."""
    if scheme == "per_token":
        return quantize_per_token(x, bits)
    if scheme == "per_tensor":
        return quantize_per_tensor(x, bits)
    if scheme == "per_group":
        return quantize_per_group(x, bits, group)
    raise ValueError(f"unknown scheme: {scheme}")


def dequantize(q: Quantized, scheme: str, group: int = 32) -> torch.Tensor:
    if scheme in ("per_token", "per_tensor"):
        return dequantize_per_token(q)
    if scheme == "per_group":
        return dequantize_per_group(q, group)
    raise ValueError(f"unknown scheme: {scheme}")
