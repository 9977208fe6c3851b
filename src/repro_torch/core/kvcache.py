"""Quantized KV cache with residual window, dense path (port of
``repro/core/kvcache.py``: ``init_cache`` / ``init_bf16_cache`` with
``ragged`` (:106-142), ``prefill`` (:167-208), ``decode_update`` (:211),
``decode_update_ragged`` (:272-330), ``prefill_chunk_ragged`` and
``bf16_prefill_chunk_ragged`` (:333-415), ``rewind_residual`` and
``truncate_rows`` (:418-471), the speculative rollback, ``packed_len``
(:474), the bf16 updates (:502-542)).

Storage between decode steps: K/V rotated and lambda-rescaled, held as
nibble-packed int4 codes + per-group fp32 scales, plus an fp32 residual
window of the W most recent tokens that is quantized into packed storage
whenever it fills.  Attention reads in rotated space.

The reference threads an immutable, donated pytree through ``lax.scan``;
here the buffers are preallocated once and updated in place, per-row
lengths included (a captured CUDA graph replays fixed addresses, so no
update may rebind a tensor).  A plain cache's ``length`` is a Python
int shared by every row, so its flush decision is taken on the host
without a device sync.  A ragged cache
(``ragged=True``, the continuous-batching slot cache) carries per-row
``(B,)`` int32 lengths on the cache's device; its decode update never
reads them back: every row quantizes its ring each step and a masked
slab write stores it only where the window just filled, writing the
current bytes back elsewhere -- the reference's semantics.  The
prompt's bulk write and every W-flush go through kernel B3
(``kernels.srft_quant``): that is the single-dispatch write the
reference's docstring names for this path, and so does each chunk of a
chunked prefill.
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
    "decode_update_ragged",
    "prefill_chunk_ragged",
    "bf16_prefill_chunk_ragged",
    "rewind_residual",
    "truncate_rows",
    "set_length",
    "packed_len",
    "dequantize_rotated",
    "gather_rotated",
    "bf16_prefill",
    "bf16_decode_update",
    "bf16_decode_update_ragged",
]

Length = "int | torch.Tensor"  # Python int, or per-row (B,) int32 (ragged)


@dataclasses.dataclass
class QuantKVCache:
    """Per-layer quantized KV state (one per layer in the model's list)."""

    k_packed: torch.Tensor  # (B, Hkv, S_max, d//2) uint8
    k_scales: torch.Tensor  # (B, Hkv, S_max, d//g) f32
    v_packed: torch.Tensor
    v_scales: torch.Tensor
    k_residual: torch.Tensor  # (B, Hkv, W, d) f32, rotated space
    v_residual: torch.Tensor
    length: Length = 0  # tokens stored: shared int, or (B,) when ragged

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
    length: Length = 0

    @property
    def s_max(self) -> int:
        return self.k.shape[-2]


# the rows a write rotates, as indices into its (B, H, S, d) K or V
# (``Rotation.forward_at``): a decode token's, or a prompt's tail
TOKEN = (slice(None), slice(None), 0)


def tail_from(n: int) -> tuple:
    return (..., slice(n, None), slice(None))


def _zero_length(batch: int, ragged: bool, device) -> Length:
    if ragged:
        return torch.zeros((batch,), dtype=torch.int32, device=device)
    return 0


def init_cache(batch: int, n_kv_heads: int, s_max: int, head_dim: int, *,
               group: int = 32, window: int = 16, ragged: bool = False,
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
        _zero_length(batch, ragged, device),
    )


def init_bf16_cache(batch: int, n_kv_heads: int, s_max: int, head_dim: int,
                    *, ragged: bool = False,
                    device: "torch.device | str" = "cpu") -> BF16KVCache:
    shape = (batch, n_kv_heads, s_max, head_dim)
    return BF16KVCache(
        torch.zeros(shape, dtype=torch.bfloat16, device=device),
        torch.zeros(shape, dtype=torch.bfloat16, device=device),
        _zero_length(batch, ragged, device),
    )


def all_rows_at(length: Length, n: int) -> Length:
    """Every row at ``n`` tokens; a ragged length is filled in place."""
    return n if isinstance(length, int) else length.fill_(n)


def _check_room(cache, new_len: int) -> None:
    if new_len > cache.s_max:
        raise ValueError(f"cache full: {new_len} tokens > s_max={cache.s_max}")


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
        cache.k_residual[:, :, :S - plen] = rot_k.forward_at(k, tail_from(plen))
        cache.v_residual[:, :, :S - plen] = rot_v.forward_at(v, tail_from(plen))
    cache.length = all_rows_at(cache.length, S)
    return cache


def decode_update(cache: QuantKVCache, rot_k: Rotation, rot_v: Rotation,
                  k: torch.Tensor, v: torch.Tensor) -> QuantKVCache:
    """Append one token (B, Hkv, 1, d) in place; when the window fills,
    quantize its W tokens into packed storage (kernel B3, no rotation:
    the window already holds rotated values)."""
    W, g = cache.window, cache.group
    _check_room(cache, cache.length + 1)
    idx = cache.length % W
    cache.k_residual[:, :, idx] = rot_k.forward_at(k, TOKEN)
    cache.v_residual[:, :, idx] = rot_v.forward_at(v, TOKEN)
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


def _rows(t: torch.Tensor) -> torch.Tensor:
    return torch.arange(t.shape[0], device=t.device)


def ring_write(res: torch.Tensor, val: torch.Tensor, idx: torch.Tensor
               ) -> None:
    """Row b writes ``val[b]`` (B, H, d) into residual slot ``idx[b]`` of
    ``res`` (B, H, W, d), in place."""
    res[_rows(idx), :, idx] = val.to(res.dtype)


def slab_write(buf: torch.Tensor, slab: torch.Tensor, off: torch.Tensor,
               do: torch.Tensor) -> None:
    """Row b stores the W-token ``slab[b]`` (H, W, c) at positions [off_b,
    off_b + W) of ``buf`` (B, H, S, c) where ``do[b]``, and writes the
    current bytes back elsewhere (gather, select, scatter: O(W) per row).
    Like ``dynamic_update_slice``, an offset is clamped so the slab fits."""
    W, S = slab.shape[2], buf.shape[2]
    pos = off.clamp(max=S - W)[:, None] + torch.arange(W, device=off.device)
    rows = _rows(off)[:, None]
    cur = buf[rows, :, pos]  # (B, W, H, c)
    buf[rows, :, pos] = torch.where(do[:, None, None, None],
                                    slab.transpose(1, 2).to(buf.dtype), cur)


def decode_update_ragged(cache: QuantKVCache, rot_k: Rotation,
                         rot_v: Rotation, k: torch.Tensor, v: torch.Tensor,
                         active: "torch.Tensor | None" = None
                         ) -> QuantKVCache:
    """Ragged append (B, Hkv, 1, d), in place: row b writes at its own
    length L_b.  Inactive rows write too (slot L_b mod W, and an
    idempotent re-flush when that slot is W-1) but keep their length, so
    the write lands at or past L_b and every read masks it.  Every row's
    ring is quantized (kernel B3, no matrix); the slab is stored only
    where the window just filled."""
    W, g = cache.window, cache.group
    L = cache.length
    idx = L % W
    # rotated as (B, H, d), the plain update's shape: the same product,
    # so a ragged single stream writes the plain one's bytes
    ring_write(cache.k_residual, rot_k.forward_at(k, TOKEN), idx)
    ring_write(cache.v_residual, rot_v.forward_at(v, TOKEN), idx)
    flush = idx == W - 1
    off = (L + 1 - W).clamp(min=0)
    kp, ks = quantize_rotated(cache.k_residual, group=g)
    vp, vs = quantize_rotated(cache.v_residual, group=g)
    for buf, slab in ((cache.k_packed, kp), (cache.k_scales, ks),
                      (cache.v_packed, vp), (cache.v_scales, vs)):
        slab_write(buf, slab, off, flush)
    L.copy_(advance(L, active))
    return cache


def chunk_write(buf: torch.Tensor, val: torch.Tensor, off: torch.Tensor
                ) -> None:
    """Row b writes its C tokens ``val[b]`` (H, C, c) at positions [off_b,
    off_b + C) of ``buf`` (B, H, S, c), in place.  Like
    ``dynamic_update_slice``, an offset is clamped so the span fits."""
    C, S = val.shape[2], buf.shape[2]
    pos = off.clamp(max=S - C)[:, None] + torch.arange(C, device=off.device)
    buf[_rows(off)[:, None], :, pos] = val.transpose(1, 2).to(buf.dtype)


def prefill_chunk_ragged(cache: QuantKVCache, rot_k: Rotation,
                         rot_v: Rotation, k: torch.Tensor, v: torch.Tensor
                         ) -> QuantKVCache:
    """Append a C-token prompt chunk (B, Hkv, C, d) at each row's own
    length, in place (chunked prefill).  Alignment contract (the batch
    engine keeps it): every row's length is a multiple of W, and only an
    admission's final chunk may have ``C % W != 0``.  Then the bytes are a
    monolithic :func:`prefill`'s: the chunk's first ``(C // W) * W`` tokens
    go through B3 into packed storage at [L_b, L_b + C // W * W), and a
    final chunk's ``C % W`` tail lands in residual slots [0, C % W), where
    the monolithic prefill puts it (quantization is per token, so a chunk
    boundary moves no byte)."""
    W, g = cache.window, cache.group
    C = k.shape[-2]
    L = cache.length
    packed_c = (C // W) * W
    if packed_c:
        kp, ks = rotate_quantize(k[..., :packed_c, :], rot_k, group=g)
        vp, vs = rotate_quantize(v[..., :packed_c, :], rot_v, group=g)
        for buf, val in ((cache.k_packed, kp), (cache.k_scales, ks),
                         (cache.v_packed, vp), (cache.v_scales, vs)):
            chunk_write(buf, val, L)
    if C - packed_c:
        cache.k_residual[:, :, :C - packed_c] = rot_k.forward_at(
            k, tail_from(packed_c))
        cache.v_residual[:, :, :C - packed_c] = rot_v.forward_at(
            v, tail_from(packed_c))
    L.add_(C)
    return cache


def advance(length: torch.Tensor, active: "torch.Tensor | None"
            ) -> torch.Tensor:
    """Per-row lengths after one append: +1 where ``active`` (all rows
    when None).  A new tensor: the updates copy it into the length."""
    if active is None:
        return length + 1
    return length + active.to(length.dtype)


def set_length(cache, new_len) -> None:
    """Every row's length to ``new_len`` (a shared int, or () / (B,) for
    a ragged cache), in place; a plain cache's int length is rebound."""
    if isinstance(cache.length, torch.Tensor):
        cache.length.copy_(torch.as_tensor(new_len).expand(
            cache.length.shape))
    else:
        cache.length = int(new_len)


def rewind_residual(final_res: torch.Tensor, snap_res: torch.Tensor,
                    base_len, new_len) -> None:
    """Rewind a mod-W residual ring (B, H, W, d), in place, to what a
    sequential run stopped at ``new_len`` holds (ref ``kvcache.py:418``).
    Slot s was written by this pass's append of position L0 + j(s), j(s)
    = (s - L0) mod W, at most once (a verify pass appends k <= W
    tokens): it keeps its final value exactly when that position survives
    (L0 + j(s) < L'), and takes the entry snapshot otherwise, rows that
    appended nothing included.  ``base_len`` (L0) and ``new_len`` (L')
    are shared ints or per-row (B,) tensors.  Packed storage is never
    rewound: a rolled-back flush's slab sits at W-aligned offsets at or
    past L' - L' mod W, every read masks it, and the next flush that
    becomes readable rewrites it whole."""
    W = final_res.shape[-2]
    dev = final_res.device
    s = torch.arange(W, device=dev)
    base = torch.as_tensor(base_len, device=dev).reshape(-1, 1)
    new = torch.as_tensor(new_len, device=dev).reshape(-1, 1)
    keep = (base + (s - base) % W) < new  # (B or 1, W)
    final_res.copy_(torch.where(keep[:, None, :, None], final_res,
                                snap_res))


def truncate_rows(cache: QuantKVCache, new_len, snap_k_res: torch.Tensor,
                  snap_v_res: torch.Tensor, base_len) -> QuantKVCache:
    """Roll a quantized cache back to ``new_len`` after a verify pass, in
    place (ref ``kvcache.py:449``): both rings rewound
    (:func:`rewind_residual`), the lengths set; packed storage untouched."""
    rewind_residual(cache.k_residual, snap_k_res, base_len, new_len)
    rewind_residual(cache.v_residual, snap_v_res, base_len, new_len)
    set_length(cache, new_len)
    return cache


def packed_len(cache: QuantKVCache) -> Length:
    """Tokens read from packed storage: [0, packed_len) packed, [packed_len,
    length) from the residual window (slot t mod W).  Per row for a ragged
    cache."""
    return cache.length - cache.length % cache.window


def dequantize_rotated(packed: torch.Tensor, scales: torch.Tensor,
                        group: int) -> torch.Tensor:
    q = quant.Quantized(packing.unpack_int4(packed), scales, 4)
    return quant.dequantize_per_group(q, group)


def gather_rotated(cache: QuantKVCache):
    """Dequantize to rotated space: ((B,H,S_max,d) k, v, packed_len).
    Values past ``packed_len`` are garbage and must be masked."""
    g = cache.group
    return (dequantize_rotated(cache.k_packed, cache.k_scales, g),
            dequantize_rotated(cache.v_packed, cache.v_scales, g),
            packed_len(cache))


def bf16_prefill(cache: BF16KVCache, k: torch.Tensor, v: torch.Tensor
                 ) -> BF16KVCache:
    S = k.shape[-2]
    _check_room(cache, S)
    cache.k[:, :, :S] = k
    cache.v[:, :, :S] = v
    cache.length = all_rows_at(cache.length, S)
    return cache


def bf16_prefill_chunk_ragged(cache: BF16KVCache, k: torch.Tensor,
                              v: torch.Tensor) -> BF16KVCache:
    """Append a C-token prompt chunk at each row's own length, in place:
    the ragged append widened from one token to C, so a chain of chunks
    holds a monolithic :func:`bf16_prefill`'s bytes."""
    chunk_write(cache.k, k, cache.length)
    chunk_write(cache.v, v, cache.length)
    cache.length.add_(k.shape[-2])
    return cache


def bf16_decode_update(cache: BF16KVCache, k: torch.Tensor, v: torch.Tensor
                       ) -> BF16KVCache:
    _check_room(cache, cache.length + 1)
    cache.k[:, :, cache.length] = k[:, :, 0]
    cache.v[:, :, cache.length] = v[:, :, 0]
    cache.length += 1
    return cache


def bf16_decode_update_ragged(cache: BF16KVCache, k: torch.Tensor,
                              v: torch.Tensor,
                              active: "torch.Tensor | None" = None
                              ) -> BF16KVCache:
    """Ragged append: row b writes at its own length L_b (clamped into the
    buffer, as ``dynamic_update_slice`` does); inactive rows write too,
    past their unchanged length, and are masked."""
    L = cache.length
    pos = L.clamp(max=cache.k.shape[-2] - 1)
    rows = _rows(L)
    cache.k[rows, :, pos] = k[:, :, 0].to(cache.k.dtype)
    cache.v[rows, :, pos] = v[:, :, 0].to(cache.v.dtype)
    L.copy_(advance(L, active))
    return cache
