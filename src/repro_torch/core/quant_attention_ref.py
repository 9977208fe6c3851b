"""Plain attention reads over the KV caches (port of
``repro/core/quant_attention_ref.py``: ``_per_row`` (:43-51),
``decode_attention_quant`` (:54-130) and ``decode_attention_bf16``
(:232-269)), the GATHER backend.  Lengths are a shared int or, for a
ragged cache, per-row ``(B,)``: every mask is then per row.

Rotated-space read of the int4 cache:

    scores  = q_eff · y_k          with q_eff = diag(1/lam_k) B q
    out_rot = softmax(scores) · y_v
    out     = rot_v.inverse(out_rot)

computed as two partial softmaxes (packed part, residual part) that are
combined, never concatenated -- the reference's order of operations.
A row of length 0 (a retired slot riding in the batch) gives a finite
output: the -1e30 sentinel and the 1e-30 floor here, zero weights in the
bf16 read.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import kvcache
from repro_torch.core.kvcache import BF16KVCache, QuantKVCache
from repro_torch.core.transforms import Rotation

__all__ = ["decode_attention_quant", "decode_attention_bf16"]

NEG = -1e30


def _per_row(x, rank: int):
    """A shared int passes through; per-row (B,) lengths become (B, 1, ...)
    so they broadcast against rank-``rank`` logits."""
    if isinstance(x, int):
        return x
    return x.reshape((-1,) + (1,) * (rank - 1))


def decode_attention_quant(q: torch.Tensor, cache: QuantKVCache,
                           rot_k: Rotation, rot_v: Rotation, *,
                           scale: Optional[float] = None,
                           sliding_window: Optional[int] = None
                           ) -> torch.Tensor:
    """q (B, Hq, 1, d) -> (B, Hq, 1, d) in the original basis."""
    B, Hq, _, d = q.shape
    Hkv = cache.k_packed.shape[1]
    G = Hq // Hkv
    sm = scale if scale is not None else d ** -0.5
    dev = q.device
    qg = (q.float() @ rot_k.folded_query_matrix().T).reshape(B, Hkv, G, d)

    yk, yv, plen = kvcache.gather_rotated(cache)
    plen, length = _per_row(plen, 4), _per_row(cache.length, 4)
    W = cache.window

    def part(keys, vals, pos, valid):
        logits = torch.einsum("bhgd,bhsd->bhgs", qg, keys) * sm
        mask = pos < valid
        if sliding_window is not None:
            mask = mask & (pos >= length - sliding_window)
        logits = torch.where(mask, logits, NEG)
        m = logits.amax(dim=-1)
        e = torch.exp(logits - m[..., None])
        return m, e.sum(dim=-1), torch.einsum("bhgs,bhsd->bhgd", e, vals)

    # packed part: positions < plen; residual token i sits at plen + i
    m_p, l_p, acc_p = part(yk, yv, torch.arange(cache.s_max, device=dev),
                           plen)
    m_r, l_r, acc_r = part(cache.k_residual, cache.v_residual,
                           plen + torch.arange(W, device=dev), length)
    m = torch.maximum(m_p, m_r)
    w_p, w_r = torch.exp(m_p - m), torch.exp(m_r - m)
    denom = (w_p * l_p + w_r * l_r).clamp_min(1e-30)
    out_rot = (w_p[..., None] * acc_p + w_r[..., None] * acc_r) \
        / denom[..., None]
    return rot_v.inverse(out_rot.reshape(B, Hq, 1, d)).to(q.dtype)


def decode_attention_bf16(q: torch.Tensor, cache: BF16KVCache, *,
                          scale: Optional[float] = None,
                          sliding_window: Optional[int] = None
                          ) -> torch.Tensor:
    """bf16 baseline decode read (grouped GQA, empty-row-safe softmax)."""
    B, Hq, _, d = q.shape
    Hkv = cache.k.shape[1]
    G = Hq // Hkv
    sm = scale if scale is not None else d ** -0.5
    k, v = cache.k.float(), cache.v.float()
    length = _per_row(cache.length, 4)
    qg = q.float().reshape(B, Hkv, G, d)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k) * sm
    pos = torch.arange(k.shape[-2], device=q.device)
    mask = pos < length
    if sliding_window is not None:
        mask = mask & (pos >= length - sliding_window)
    logits = torch.where(mask, logits, -torch.inf)
    # a fully-masked row yields zero weights (finite output), not NaN
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - torch.where(torch.isfinite(m), m, 0.0))
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v).reshape(B, Hq, 1, d)
    return out.to(q.dtype)
