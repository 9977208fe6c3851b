"""Blockwise (flash-style) prefill attention in plain PyTorch (port of
``repro/models/flash.py:20``): a loop over KV blocks with an online
softmax and the -1e30 mask sentinel, GQA-aware without repeating KV
heads.  The reference is jnp, not Pallas, so this stays plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["flash_attention"]

_NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    scale: Optional[float] = None,
                    kv_block: int = 1024) -> torch.Tensor:
    """Attention: q (B, Hq, Sq, d), k/v (B, Hkv, Skv, d) -> (B, Hq, Sq, d)
    in q.dtype; ``q_offset`` is the absolute position of q[..., 0, :].
    ``causal=False`` (an encoder, a cross-attention) lets every query see
    every key; the padding of a length that is no multiple of
    ``kv_block`` stays masked either way."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    sm = scale if scale is not None else d ** -0.5
    blk = min(kv_block, Skv)
    n_blk = -(-Skv // blk)
    pad = n_blk * blk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    dev = q.device

    qg = q.reshape(B, Hkv, G, Sq, d).float() * sm
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Hkv, G, Sq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, d), dtype=torch.float32, device=dev)
    for j in range(n_blk):
        kj = k[:, :, j * blk:(j + 1) * blk].float()
        vj = v[:, :, j * blk:(j + 1) * blk].float()
        kv_pos = j * blk + torch.arange(blk, device=dev)
        logits = torch.einsum("bhgqd,bhsd->bhgqs", qg, kj)
        mask = kv_pos[None, :] < Skv
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        logits = torch.where(mask, logits, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqs,bhsd->bhgqd", p, vj)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, Sq, d).to(q.dtype)
