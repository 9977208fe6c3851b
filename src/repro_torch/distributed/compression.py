"""Gradient compression for a cross-pod all-reduce: int8 per-block
quantization with error feedback (port of
``repro/distributed/compression.py``).

Each block of 256 values is scaled by its abs-max / 127, rounded half to
even (``torch.round``, as ``jnp.rint``) and clipped to [-127, 127]; the
scale has a floor of 1e-12 / 127.  Error feedback (Seide et al., EF-SGD)
keeps the quantization residual of each participant and adds it to the
next step's input, so the running sum of what the wire carried tracks the
running sum of the inputs.

The port is single-controller (``launch/mesh.py``): ``compressed_psum``
takes every participant's tensor and state at once, one per index of the
reduced axis, in mesh order, and returns each participant's copy of the
sum on that participant's device.  That is the reference's
``compressed_psum`` inside ``shard_map`` with ``jax.lax.psum`` over the
axis.  The wire carries the int8 codes and one fp32 scale a block: a
quarter of fp32's bytes plus 1/256 of them.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

__all__ = ["EFState", "ef_init", "compress_decompress", "compressed_psum"]

_BLOCK = 256


class EFState(NamedTuple):
    residual: torch.Tensor  # fp32, the gradient leaf's shape


def ef_init(x: torch.Tensor) -> EFState:
    return EFState(residual=torch.zeros_like(x, dtype=torch.float32))


def _quantize_blocks(x: torch.Tensor, bits: int = 8):
    """(codes (n_blocks, 256) fp32 integers, scales (n_blocks, 1) fp32, n):
    ``x`` flattened and zero-padded to whole blocks."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, (-n) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    qmax = 2 ** (bits - 1) - 1
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds some scales one ulp off the quotient
    scale = blocks.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / \
        torch.tensor(float(qmax), device=blocks.device)
    codes = torch.round(blocks / scale).clamp(-qmax, qmax)
    return codes, scale, n


def _dequantize_blocks(codes, scale, n: int, shape) -> torch.Tensor:
    return (codes * scale).reshape(-1)[:n].reshape(shape)


def compress_decompress(x: torch.Tensor, state: EFState, *, bits: int = 8):
    """Local quantize round trip with error feedback (no collective):
    (x_hat in x's dtype, the new state).  x_hat is what the wire carries."""
    xf = x.float() + state.residual
    codes, scale, n = _quantize_blocks(xf, bits)
    x_hat = _dequantize_blocks(codes, scale, n, x.shape)
    return x_hat.to(x.dtype), EFState(residual=xf - x_hat)


def compressed_psum(xs: Sequence[torch.Tensor], states: Sequence[EFState],
                    *, bits: int = 8):
    """Error-feedback int8 all-reduce over the participants of one mesh
    axis: ``xs[i]`` and ``states[i]`` are participant i's (index i of the
    axis, on its device).  Each quantizes with its own state; the
    participants' ``codes * scale`` are summed in index order on the first
    participant's device.  Returns (outs, new_states): ``outs[i]`` the sum
    in ``xs[i]``'s dtype on its device, ``new_states[i]`` its residual."""
    if len(xs) != len(states) or not xs:
        raise ValueError(f"{len(xs)} tensors and {len(states)} states: one "
                         f"of each per participant")
    lead = xs[0].device
    total, new_states = None, []
    for x, st in zip(xs, states):
        xf = x.float() + st.residual
        codes, scale, n = _quantize_blocks(xf, bits)
        new_states.append(EFState(
            residual=xf - _dequantize_blocks(codes, scale, n, x.shape)))
        wire = (codes * scale).to(lead)
        total = wire if total is None else total + wire
    out = total.reshape(-1)[:n].reshape(xs[0].shape)
    return [out.to(x.device, x.dtype, copy=True) for x in xs], new_states
