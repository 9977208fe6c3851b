"""Quantized KV cache with residual window, dense non-ragged path (port of
``repro/core/kvcache.py``).

Storage between decode steps: K/V rotated and lambda-rescaled, held as
nibble-packed int4 codes + per-group fp32 scales, plus an fp32 residual
window of the W most recent tokens that is quantized into packed storage
whenever it fills.  Attention reads in rotated space.

The reference threads an immutable, donated pytree through ``lax.scan``;
here the buffers are preallocated once and updated in place, and the
shared ``length`` is a Python int (every row is at the same position),
so the flush decision is taken on the host without a device sync.  Both
the prompt's bulk write and every W-flush go through kernel B3
(``kernels.srft_quant``): that is the single-dispatch write the
reference's docstring names for this path.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packing, quant
from repro_torch.core.transforms import Rotation
from repro_torch.kernels.srft_quant.ops import quantize_rotated, rotate_quantize

__all__ = [
    "QuantKVCache",
    "BF16KVCache",
    "init_cache",
    "init_bf16_cache",
    "prefill",
    "decode_update",
    "packed_len",
    "gather_rotated",
    "bf16_prefill",
    "bf16_decode_update",
]


@dataclasses.dataclass
class QuantKVCache:
    """Per-layer quantized KV state (one per layer in the model's list)."""

    k_packed: torch.Tensor  # (B, Hkv, S_max, d//2) uint8
    k_scales: torch.Tensor  # (B, Hkv, S_max, d//g) f32
    v_packed: torch.Tensor
    v_scales: torch.Tensor
    k_residual: torch.Tensor  # (B, Hkv, W, d) f32, rotated space
    v_residual: torch.Tensor
    length: int = 0  # tokens stored (shared by every row)

    @property
    def window(self) -> int:
        return self.k_residual.shape[-2]

    @property
    def s_max(self) -> int:
        return self.k_packed.shape[-2]

    @property
    def head_dim(self) -> int:
        return self.k_residual.shape[-1]

    @property
    def group(self) -> int:
        return self.head_dim // self.k_scales.shape[-1]


@dataclasses.dataclass
class BF16KVCache:
    """Uncompressed baseline."""

    k: torch.Tensor  # (B, Hkv, S_max, d) bf16
    v: torch.Tensor
    length: int = 0


def init_cache(batch: int, n_kv_heads: int, s_max: int, head_dim: int, *,
               group: int = 32, window: int = 16,
               device: "torch.device | str" = "cpu") -> QuantKVCache:
    if head_dim % 2 or head_dim % group:
        raise ValueError(f"head_dim={head_dim} must divide 2 and group={group}")

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    shape_p = (batch, n_kv_heads, s_max, head_dim // 2)
    shape_s = (batch, n_kv_heads, s_max, head_dim // group)
    shape_r = (batch, n_kv_heads, window, head_dim)
    return QuantKVCache(
        z(shape_p, torch.uint8), z(shape_s, torch.float32),
        z(shape_p, torch.uint8), z(shape_s, torch.float32),
        z(shape_r, torch.float32), z(shape_r, torch.float32),
    )


def init_bf16_cache(batch: int, n_kv_heads: int, s_max: int, head_dim: int,
                    *, device: "torch.device | str" = "cpu") -> BF16KVCache:
    shape = (batch, n_kv_heads, s_max, head_dim)
    return BF16KVCache(
        torch.zeros(shape, dtype=torch.bfloat16, device=device),
        torch.zeros(shape, dtype=torch.bfloat16, device=device),
    )


def _check_room(cache, new_len: int) -> None:
    s_max = cache.s_max if isinstance(cache, QuantKVCache) else cache.k.shape[-2]
    if new_len > s_max:
        raise ValueError(f"cache full: {new_len} tokens > s_max={s_max}")


def prefill(cache: QuantKVCache, rot_k: Rotation, rot_v: Rotation,
            k: torch.Tensor, v: torch.Tensor) -> QuantKVCache:
    """Bulk-insert S prompt tokens (B, Hkv, S, d) in place: quantize all but
    the last S mod W (kernel B3), keep those in the residual window."""
    S = k.shape[-2]
    W, g = cache.window, cache.group
    _check_room(cache, S)
    plen = (S // W) * W
    if plen:
        kp, ks = rotate_quantize(k[..., :plen, :], rot_k, group=g)
        vp, vs = rotate_quantize(v[..., :plen, :], rot_v, group=g)
        cache.k_packed[:, :, :plen] = kp
        cache.k_scales[:, :, :plen] = ks
        cache.v_packed[:, :, :plen] = vp
        cache.v_scales[:, :, :plen] = vs
    if S - plen:
        cache.k_residual[:, :, :S - plen] = rot_k.forward(k[..., plen:, :])
        cache.v_residual[:, :, :S - plen] = rot_v.forward(v[..., plen:, :])
    cache.length = S
    return cache


def decode_update(cache: QuantKVCache, rot_k: Rotation, rot_v: Rotation,
                  k: torch.Tensor, v: torch.Tensor) -> QuantKVCache:
    """Append one token (B, Hkv, 1, d) in place; when the window fills,
    quantize its W tokens into packed storage (kernel B3, no rotation:
    the window already holds rotated values)."""
    W, g = cache.window, cache.group
    _check_room(cache, cache.length + 1)
    idx = cache.length % W
    cache.k_residual[:, :, idx] = rot_k.forward(k[:, :, 0])
    cache.v_residual[:, :, idx] = rot_v.forward(v[:, :, 0])
    cache.length += 1
    if idx == W - 1:
        off = cache.length - W  # first token index of the window
        kp, ks = quantize_rotated(cache.k_residual, group=g)
        vp, vs = quantize_rotated(cache.v_residual, group=g)
        cache.k_packed[:, :, off:off + W] = kp
        cache.k_scales[:, :, off:off + W] = ks
        cache.v_packed[:, :, off:off + W] = vp
        cache.v_scales[:, :, off:off + W] = vs
    return cache


def packed_len(cache: QuantKVCache) -> int:
    """Tokens read from packed storage: [0, packed_len) packed, [packed_len,
    length) from the residual window (slot t mod W)."""
    return cache.length - cache.length % cache.window


def _dequantize_rotated(packed: torch.Tensor, scales: torch.Tensor,
                        group: int) -> torch.Tensor:
    q = quant.Quantized(packing.unpack_int4(packed), scales, 4)
    return quant.dequantize_per_group(q, group)


def gather_rotated(cache: QuantKVCache):
    """Dequantize to rotated space: ((B,H,S_max,d) k, v, packed_len).
    Values past ``packed_len`` are garbage and must be masked."""
    g = cache.group
    return (_dequantize_rotated(cache.k_packed, cache.k_scales, g),
            _dequantize_rotated(cache.v_packed, cache.v_scales, g),
            packed_len(cache))


def bf16_prefill(cache: BF16KVCache, k: torch.Tensor, v: torch.Tensor
                 ) -> BF16KVCache:
    S = k.shape[-2]
    _check_room(cache, S)
    cache.k[:, :, :S] = k
    cache.v[:, :, :S] = v
    cache.length = S
    return cache


def bf16_decode_update(cache: BF16KVCache, k: torch.Tensor, v: torch.Tensor
                       ) -> BF16KVCache:
    _check_room(cache, cache.length + 1)
    cache.k[:, :, cache.length] = k[:, :, 0]
    cache.v[:, :, cache.length] = v[:, :, 0]
    cache.length += 1
    return cache
