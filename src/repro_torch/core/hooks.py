"""KV quantization round-trip hooks (port of ``repro/core/hooks.py``): the
paper's §3.3 KV-cache simulation.  K/V go through rotate -> quantize ->
dequantize -> inverse-rotate before attention, so a full forward pass
measures hook ΔPPL as the paper does on k_proj/v_proj outputs.  Plain
PyTorch, as in the reference: the hook does not go through B3/B4.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.transforms import Rotation

__all__ = ["kv_roundtrip", "make_roundtrip"]


def _roundtrip_one(x: torch.Tensor, rot: Rotation, *, bits: int,
                   scheme: str, group: int) -> torch.Tensor:
    """(B, H, S, d) -> the same, with quantization error injected."""
    y = rot.forward(x)  # lambda applied here (per-channel scaling)
    if scheme in ("per_token", "per_channel"):
        # per_channel: lambda rescale + one per-token scale
        yq = quant.dequantize_per_token(quant.quantize_per_token(y, bits))
    elif scheme == "per_tensor":
        yq = quant.dequantize_per_tensor(quant.quantize_per_tensor(y, bits))
    elif scheme in ("per_group", "per_channel_group"):
        # per_channel_group: the per-channel part is rot.lam
        yq = quant.dequantize_per_group(
            quant.quantize_per_group(y, bits, group), group)
    else:
        raise ValueError(f"unknown scheme {scheme}")
    return rot.inverse(yq).to(x.dtype)


def kv_roundtrip(k: torch.Tensor, v: torch.Tensor, rot_k: Rotation,
                 rot_v: Rotation, *, bits: int = 4, scheme: str = "per_group",
                 group: int = 32):
    return (_roundtrip_one(k, rot_k, bits=bits, scheme=scheme, group=group),
            _roundtrip_one(v, rot_v, bits=bits, scheme=scheme, group=group))


def make_roundtrip(rot_k: Rotation, rot_v: Rotation, *, bits: int = 4,
                   scheme: str = "per_group", group: int = 32):
    """``(k, v) -> (k~, v~)`` with the rotations and scheme closed over."""
    def fn(k, v):
        return kv_roundtrip(k, v, rot_k, rot_v, bits=bits, scheme=scheme,
                            group=group)
    return fn
