"""int4 nibble packing (port of ``repro/core/packing.py``).

byte = (q[2i+1] << 4) | (q[2i] & 0xF)   -- two signed int4 per uint8;
the low nibble is the even index, and unpacking sign-extends.
"""
from __future__ import annotations

import torch

__all__ = ["pack_int4", "unpack_int4", "packed_nbytes"]


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int codes in [-8, 7] along the last axis: (..., d) -> (..., d//2)."""
    d = codes.shape[-1]
    if d % 2:
        raise ValueError(f"last dim must be even, got {d}")
    c = codes.to(torch.int32) & 0xF
    return ((c[..., 1::2] << 4) | c[..., 0::2]).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., d//2) uint8 -> (..., d) int8."""
    p = packed.to(torch.int32)
    low = p & 0xF
    high = (p >> 4) & 0xF
    low = torch.where(low >= 8, low - 16, low)
    high = torch.where(high >= 8, high - 16, high)
    stacked = torch.stack([low, high], dim=-1)  # (..., d//2, 2)
    return stacked.reshape(*packed.shape[:-1], packed.shape[-1] * 2).to(
        torch.int8)


def packed_nbytes(d: int, bits: int) -> int:
    """Bytes per d-vector of codes at the given bit width."""
    if bits == 4:
        return d // 2
    if bits == 8:
        return d
    raise ValueError(f"only 4/8-bit packing supported, got {bits}")
