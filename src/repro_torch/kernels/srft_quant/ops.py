"""Wrappers for kernel B3, the fused rotate + quantize + pack, and kernel
B4, its inverse: unpack + dequantize + inverse rotation (port of
``repro/kernels/srft_quant/ops.py``).

On a CPU tensor a wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches ``csrc/srft_quant.cu`` or raises; on a ``meta`` tensor
it checks the arguments and returns outputs of the kernel's shapes and
dtypes, computing nothing.  On ``cuda`` and ``meta`` each call adds its
analytic cost to an active cost census (``launch/cost.py``).
``launches`` (B3) and ``dequant_launches`` (B4) count kernel launches
(plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.srft_quant.ref import (
    fold_inverse_matrix,
    srft_dequant_ref,
    srft_quant_ref,
)
from repro_torch.launch import cost

__all__ = ["srft_quant", "srft_dequant", "rotate_quantize",
           "dequantize_rotate", "quantize_rotated", "launches",
           "dequant_launches", "ARGTYPES"]

launches = 0  # B3 launches since the caller last set this to 0
dequant_launches = 0  # B4 launches since the caller last set this to 0
_FNS: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C signatures of csrc/srft_quant.cu's launch functions
ARGTYPES = {"srft_quant_launch": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
            "srft_dequant_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P]}


def _fn(name: str):
    if name not in _FNS:
        lib = _build.library("srft_quant")
        fn = getattr(lib, name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = _I
        _FNS[name] = (lib, fn)
    return _FNS[name]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(x, m, lam, group, bits):
    global launches
    n, d = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"x must be contiguous fp32/bf16, got {x.dtype}")
    if d % 2 or d % group or group % 2 or d > 256 or bits not in (4, 8):
        raise ValueError(f"unsupported d={d} group={group} bits={bits}")
    for name, t, shape in (("m", m, (d, d)), ("lam", lam, (d,))):
        if t is None:
            continue
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 {shape} on "
                             f"{x.device}")
    out = torch.empty((n, d // 2) if bits == 4 else (n, d),
                      dtype=torch.uint8 if bits == 4 else torch.int8,
                      device=x.device)
    scales = torch.empty((n, d // group), dtype=torch.float32, device=x.device)
    if x.device.type == "cuda":
        lib, fn = _fn("srft_quant_launch")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), _ptr(m),
                    _ptr(lam), out.data_ptr(), scales.data_ptr(), n, d,
                    group, bits, stream)
        _build.check(lib, "srft_quant", rc)
        launches += 1
    if cost.ACTIVE:
        cost.record_kernel("srft_quant", **cost.kernel_cost_b3(
            n, d, group, x_itemsize=x.element_size(), matrix=m is not None,
            lam=lam is not None, bits=bits))
    return out, scales


def srft_quant(x: torch.Tensor, m: Optional[torch.Tensor],
               lam: Optional[torch.Tensor] = None, *, group: int = 32,
               bits: int = 4):
    """x (N, d) -> (packed, scales); see ``ref.srft_quant_ref``."""
    if x.device.type == "cpu":
        return srft_quant_ref(x, m, lam, group=group, bits=bits)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"srft_quant runs on cpu, cuda or meta, not "
                         f"{x.device}")
    return _launch(x, m, lam, group, bits)


def _launch_dequant(packed, scales, minv, group, bits):
    global dequant_launches
    n = packed.shape[0]
    d = packed.shape[1] * 2 if bits == 4 else packed.shape[1]
    want = torch.uint8 if bits == 4 else torch.int8
    if bits not in (4, 8) or packed.dtype != want or not packed.is_contiguous():
        raise ValueError(f"bits={bits} needs contiguous {want} codes, got "
                         f"{packed.dtype}")
    if d % 2 or group <= 0 or d % group or group % 2 or d > 256:
        raise ValueError(f"unsupported d={d} group={group}")
    for name, t, shape in (("scales", scales, (n, d // group)),
                           ("minv", minv, (d, d))):
        if (t.device != packed.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 {shape} on "
                             f"{packed.device}")
    out = torch.empty((n, d), dtype=torch.float32, device=packed.device)
    if packed.device.type == "cuda":
        lib, fn = _fn("srft_dequant_launch")
        with torch.cuda.device(packed.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(packed.data_ptr(), scales.data_ptr(), minv.data_ptr(),
                    out.data_ptr(), n, d, group, bits, stream)
        _build.check(lib, "srft_quant", rc)
        dequant_launches += 1
    if cost.ACTIVE:
        cost.record_kernel("srft_dequant",
                           **cost.kernel_cost_b4(n, d, group, bits=bits))
    return out


def srft_dequant(packed: torch.Tensor, scales: torch.Tensor,
                 minv: torch.Tensor, *, group: int = 32, bits: int = 4
                 ) -> torch.Tensor:
    """(packed (N, d/2|d), scales (N, d/group)) -> x (N, d) fp32; see
    ``ref.srft_dequant_ref``."""
    if packed.device.type == "cpu":
        return srft_dequant_ref(packed, scales, minv, group=group, bits=bits)
    if packed.device.type not in ("cuda", "meta"):
        raise ValueError(f"srft_dequant runs on cpu, cuda or meta, not "
                         f"{packed.device}")
    return _launch_dequant(packed, scales, minv, group, bits)


def _flat(fn, x: torch.Tensor, *args, group: int, bits: int):
    lead, d = x.shape[:-1], x.shape[-1]
    packed, scales = fn(x.reshape(-1, d).contiguous(), *args, group=group,
                        bits=bits)
    return (packed.reshape(*lead, packed.shape[-1]),
            scales.reshape(*lead, d // group))


def rotate_quantize(x: torch.Tensor, rot, *, group: int = 32, bits: int = 4):
    """x (..., d) raw -> codes of ``rot.forward(x)``: (packed, scales).

    The rotation matrix goes in unfolded and lambda as the epilogue, the
    order of ``Rotation.forward``, so the bytes are the cache's."""
    return _flat(srft_quant, x, rot.matrix, rot.lam, group=group, bits=bits)


def quantize_rotated(y: torch.Tensor, *, group: int = 32, bits: int = 4):
    """y (..., d) already rotated -> (packed, scales): the W-flush."""
    return _flat(srft_quant, y, None, None, group=group, bits=bits)


def dequantize_rotate(packed: torch.Tensor, scales: torch.Tensor, rot, *,
                      group: int = 32, bits: int = 4) -> torch.Tensor:
    """Inverse of the folded write ``srft_quant(x, fold_matrix(rot))``
    (ref ``ops.py:46``): (packed (..., d/2|d), scales (..., d/group)) ->
    (..., d) fp32, through B4 with the folded inverse matrix."""
    lead = packed.shape[:-1]
    d = packed.shape[-1] * 2 if bits == 4 else packed.shape[-1]
    x = srft_dequant(packed.reshape(-1, packed.shape[-1]).contiguous(),
                     scales.reshape(-1, d // group).contiguous(),
                     fold_inverse_matrix(rot), group=group, bits=bits)
    return x.reshape(*lead, d)
