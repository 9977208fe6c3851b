"""Plain attention reads over the KV caches (port of
``repro/core/quant_attention_ref.py``: ``_per_row`` (:43-51),
``decode_attention_quant`` (:54-130) and ``decode_attention_bf16``
(:232-269), the GATHER backend; ``decode_attention_quant_blockwise``
(:133-229) and ``decode_attention_bf16_blockwise`` (:272-319), the
BLOCKWISE backend; ``_per_query_lengths``, ``verify_attention_quant`` and
``verify_attention_bf16`` (:357-478), the k-query reads of a speculative
verify pass, served with GATHER's numerics).  Lengths are a shared int
or, for a ragged cache, per-row ``(B,)``: every mask is then per row.

Rotated-space read of the int4 cache:

    scores  = q_eff · y_k          with q_eff = diag(1/lam_k) B q
    out_rot = softmax(scores) · y_v
    out     = rot_v.inverse(out_rot)

computed as two partial softmaxes (packed part, residual part) that are
combined, never concatenated -- the reference's order of operations.
A row of length 0 (a retired slot riding in the batch) gives a finite
output: the -1e30 sentinel and the 1e-30 floor here, zero weights in the
bf16 read.

``return_lse=True`` makes a decode read also return each query's
log-sum-exp of its scaled scores, ``(B, Hq, 1)`` fp32, the weight a read
split by position over shards combines its parts by
(``launch/sharded_cache.py``).  A read with no valid position gives
-1e30 (the sentinel, as kernel B1 does), never -inf, so that its weight
beside any valid part is exactly 0 and a combine of empty parts stays
finite.  ``packed_len`` overrides an int4 read's ``L - L mod W`` (a
shard's packed segment need not end on a multiple of W).

BLOCKWISE is the flash-decode tiling of the B1 kernel in plain PyTorch:
``ceil(s_max / kv_block)`` tiles, always all of them (the reference's
``lax.scan``, with no exit that depends on the data, so a captured decode
step replays it), the last tile's start clamped to ``s_max - kv_block``
and the rows an earlier tile covered masked.  It never materializes the
whole dequantized prefix or an ``s_max``-long logits row.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import kvcache
from repro_torch.core.kvcache import BF16KVCache, QuantKVCache
from repro_torch.core.transforms import Rotation

__all__ = ["decode_attention_quant", "decode_attention_quant_blockwise",
           "decode_attention_bf16", "decode_attention_bf16_blockwise",
           "verify_attention_quant", "verify_attention_bf16",
           "verify_rings"]

NEG = -1e30


def _per_row(x, rank: int):
    """A shared int passes through; per-row (B,) lengths become (B, 1, ...)
    so they broadcast against rank-``rank`` logits."""
    if isinstance(x, int):
        return x
    return x.reshape((-1,) + (1,) * (rank - 1))


def _fold_query(q: torch.Tensor, rot_k: Rotation, Hkv: int) -> torch.Tensor:
    """q (B, Hq, 1, d) -> q_eff (B, Hkv, G, d) = diag(1/lam_k) B q, fp32."""
    B, Hq, _, d = q.shape
    return (q.float() @ rot_k.folded_query_matrix().T).reshape(
        B, Hkv, Hq // Hkv, d)


def _quant_read(qg, yk, yv, ring_k, ring_v, plen, length, sm,
                sliding_window, return_lse: bool = False):
    """One query's two-part read: the packed part (positions < ``plen``
    of the dequantized ``yk`` / ``yv``) and the residual ring (token i at
    ``plen + i``, valid below ``length``), combined.  ``qg`` (B, Hkv, G,
    d); returns out_rot (B, Hkv, G, d), and with ``return_lse`` its (B,
    Hkv, G) log-sum-exp.  Decode and verify both read through here, so a
    verify query runs a decode step's operations in the same order."""
    dev = qg.device
    plen, length = _per_row(plen, 4), _per_row(length, 4)
    W = ring_k.shape[-2]

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
    m_p, l_p, acc_p = part(yk, yv, torch.arange(yk.shape[-2], device=dev),
                           plen)
    m_r, l_r, acc_r = part(ring_k, ring_v,
                           plen + torch.arange(W, device=dev), length)
    m = torch.maximum(m_p, m_r)
    w_p, w_r = torch.exp(m_p - m), torch.exp(m_r - m)
    denom = (w_p * l_p + w_r * l_r).clamp_min(1e-30)
    out = (w_p[..., None] * acc_p + w_r[..., None] * acc_r) \
        / denom[..., None]
    return (out, m + torch.log(denom)) if return_lse else out


def decode_attention_quant(q: torch.Tensor, cache: QuantKVCache,
                           rot_k: Rotation, rot_v: Rotation, *,
                           scale: Optional[float] = None,
                           sliding_window: Optional[int] = None,
                           packed_len=None, return_lse: bool = False):
    """q (B, Hq, 1, d) -> (B, Hq, 1, d) in the original basis (and its
    (B, Hq, 1) log-sum-exp with ``return_lse``)."""
    B, Hq, _, d = q.shape
    sm = scale if scale is not None else d ** -0.5
    qg = _fold_query(q, rot_k, cache.k_packed.shape[1])
    yk, yv, plen = kvcache.gather_rotated(cache)
    if packed_len is not None:
        plen = packed_len
    got = _quant_read(qg, yk, yv, cache.k_residual, cache.v_residual,
                      plen, cache.length, sm, sliding_window, return_lse)
    out_rot, lse = got if return_lse else (got, None)
    out = rot_v.inverse(out_rot.reshape(B, Hq, 1, d)).to(q.dtype)
    return (out, lse.reshape(B, Hq, 1)) if return_lse else out


def _per_query_lengths(base_len, kq: int) -> torch.Tensor:
    """(B, kq) view lengths L_i = L0 + i + 1 of the i-th verify query, or
    (1, kq) for a shared length (ref ``quant_attention_ref.py:357``)."""
    if isinstance(base_len, torch.Tensor):
        i = torch.arange(kq, device=base_len.device, dtype=base_len.dtype)
        return base_len.reshape(-1, 1) + i[None, :] + 1
    return (base_len + torch.arange(kq) + 1)[None, :]


def verify_rings(ring_k: torch.Tensor, ring_v: torch.Tensor,
                 snap_k: torch.Tensor, snap_v: torch.Tensor, plen_i,
                 base_len) -> tuple:
    """The residual rings (B, H, W, d) as the verify query whose packed
    length is ``plen_i`` saw them: slot s from the live ring where this
    pass wrote it at a position the query may see (``plen_i + s >= L0``,
    L0 = ``base_len``), else from the entry snapshot.  ``plen_i`` and
    ``base_len`` are shared ints or per-row (B,) tensors."""
    W = ring_k.shape[-2]
    slots = torch.arange(W, device=ring_k.device)
    plen = torch.as_tensor(plen_i, device=ring_k.device).reshape(-1, 1)
    sel = (plen + slots >= _per_row(base_len, 2))[:, None, :, None]
    return (torch.where(sel, ring_k, snap_k),
            torch.where(sel, ring_v, snap_v))


def verify_attention_quant(q: torch.Tensor, cache: QuantKVCache,
                           rot_k: Rotation, rot_v: Rotation, *,
                           snap_k_res: torch.Tensor,
                           snap_v_res: torch.Tensor, base_len,
                           scale: Optional[float] = None,
                           sliding_window: Optional[int] = None
                           ) -> torch.Tensor:
    """Score kq <= W verify queries (B, Hq, kq, d) against a cache that
    holds all kq appended tokens, each against its own historical prefix
    L_i = L0 + i + 1 (ref ``quant_attention_ref.py:364``).  Returns (B,
    Hq, kq, d) in the original basis.

    Packed storage is append-only within a pass, so the final arrays
    restricted to [0, plen_i) are what step i saw.  The ring is a mod-W
    overwrite structure: query i takes slot s from the final ring when
    this pass wrote it at a position the query may see (plen_i + s >=
    L0) and from the entry snapshot otherwise (with kq <= W each slot is
    written at most once a pass).  Each query then runs
    :func:`decode_attention_quant`'s operations, in its order and at its
    shapes (the fold, ``_quant_read``, the inverse, one query at a
    time), so it equals the decode step's read bit for bit; the
    dequantized packed arrays are shared by the kq queries."""
    B, Hq, kq, d = q.shape
    Hkv, W = cache.k_packed.shape[1], cache.window
    sm = scale if scale is not None else d ** -0.5
    yk, yv, _ = kvcache.gather_rotated(cache)
    lengths = _per_query_lengths(base_len, kq)
    outs = []
    for i in range(kq):
        L_i = lengths[:, i].to(q.device)
        plen_i = L_i - L_i % W
        ring_k, ring_v = verify_rings(cache.k_residual, cache.v_residual,
                                      snap_k_res, snap_v_res, plen_i,
                                      base_len)
        qg = _fold_query(q[:, :, i:i + 1], rot_k, Hkv)
        out_rot = _quant_read(qg, yk, yv, ring_k, ring_v, plen_i, L_i, sm,
                              sliding_window)
        outs.append(rot_v.inverse(out_rot.reshape(B, Hq, 1, d)))
    return torch.cat(outs, dim=2).to(q.dtype)


def _tiles(s_max: int, kv_block: int):
    """(tile index, clamped start, tile length) of the flash-decode tiles."""
    blk = min(kv_block, s_max)
    for j in range(-(-s_max // blk)):
        yield j, min(j * blk, s_max - blk), blk


def _online_step(state, logits, vals, mask):
    """One online-softmax step: fold a tile's masked logits (B, Hkv, G, 1,
    n) and values (B, Hkv, n, d) into (m, l, acc)."""
    m, l, acc = state
    logits = torch.where(mask, logits, NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    corr = torch.exp(m - m_new)
    return (m_new, l * corr + p.sum(dim=-1),
            acc * corr[..., None] + torch.einsum("bhgqs,bhsd->bhgqd", p,
                                                 vals))


def _online_init(B, Hkv, G, d, device):
    return (torch.full((B, Hkv, G, 1), NEG, device=device),
            torch.zeros((B, Hkv, G, 1), device=device),
            torch.zeros((B, Hkv, G, 1, d), device=device))


def decode_attention_quant_blockwise(q: torch.Tensor, cache: QuantKVCache,
                                     rot_k: Rotation, rot_v: Rotation, *,
                                     scale: Optional[float] = None,
                                     sliding_window: Optional[int] = None,
                                     kv_block: int = 512, packed_len=None,
                                     return_lse: bool = False):
    """Flash-decode over the packed cache, dequantizing tile by tile, then
    the fp32 residual window as one more tile: q (B, Hq, 1, d) -> (B, Hq,
    1, d) in the original basis (and its (B, Hq, 1) log-sum-exp with
    ``return_lse``)."""
    B, Hq, _, d = q.shape
    Hkv = cache.k_packed.shape[1]
    G = Hq // Hkv
    g, W = cache.group, cache.window
    sm = scale if scale is not None else d ** -0.5
    dev = q.device
    plen = _per_row(kvcache.packed_len(cache) if packed_len is None
                    else packed_len, 5)
    length = _per_row(cache.length, 5)
    qg = (q.float() @ rot_k.folded_query_matrix().T).reshape(
        B, Hkv, G, 1, d) * sm

    state = _online_init(B, Hkv, G, d, dev)
    for j, start, blk in _tiles(cache.s_max, kv_block):
        tile = slice(start, start + blk)
        kj = kvcache.dequantize_rotated(cache.k_packed[:, :, tile],
                                        cache.k_scales[:, :, tile], g)
        vj = kvcache.dequantize_rotated(cache.v_packed[:, :, tile],
                                        cache.v_scales[:, :, tile], g)
        kv_pos = start + torch.arange(blk, device=dev)
        mask = (kv_pos < plen) & (kv_pos >= j * blk)
        if sliding_window is not None:
            mask = mask & (kv_pos > length - 1 - sliding_window)
        state = _online_step(state, torch.einsum("bhgqd,bhsd->bhgqs", qg, kj),
                             vj, mask)

    # the residual window: token i sits at plen + i
    pos_r = plen + torch.arange(W, device=dev)
    mask = pos_r < length
    if sliding_window is not None:
        mask = mask & (pos_r > length - 1 - sliding_window)
    m, l, acc = _online_step(
        state, torch.einsum("bhgqd,bhsd->bhgqs", qg, cache.k_residual),
        cache.v_residual, mask)
    l = l.clamp_min(1e-30)
    out_rot = acc / l[..., None]
    out = rot_v.inverse(out_rot.reshape(B, Hq, 1, d)).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, Hq, 1)
    return out


def _bf16_read(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length,
               sm: float, sliding_window, return_lse: bool = False):
    """One query (B, Hq, 1, d) over fp32 K/V (B, Hkv, S, d) valid below
    ``length``: (B, Hq, 1, d) fp32, and with ``return_lse`` its (B, Hq, 1)
    log-sum-exp (-1e30 for a query with no valid position).  Decode and
    verify read through here."""
    B, Hq, _, d = q.shape
    Hkv = k.shape[1]
    length = _per_row(length, 4)
    qg = q.float().reshape(B, Hkv, Hq // Hkv, d)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k) * sm
    pos = torch.arange(k.shape[-2], device=q.device)
    mask = pos < length
    if sliding_window is not None:
        mask = mask & (pos >= length - sliding_window)
    logits = torch.where(mask, logits, -torch.inf)
    # a fully-masked row yields zero weights (finite output), not NaN
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - torch.where(torch.isfinite(m), m, 0.0))
    total = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgs,bhsd->bhgd", e / total, v).reshape(B, Hq, 1, d)
    if not return_lse:
        return out
    lse = torch.where(torch.isfinite(m), m + torch.log(total), NEG)
    return out, lse.reshape(B, Hq, 1)


def decode_attention_bf16(q: torch.Tensor, cache: BF16KVCache, *,
                          scale: Optional[float] = None,
                          sliding_window: Optional[int] = None,
                          return_lse: bool = False):
    """bf16 baseline decode read (grouped GQA, empty-row-safe softmax);
    with ``return_lse`` also its (B, Hq, 1) log-sum-exp."""
    sm = scale if scale is not None else q.shape[-1] ** -0.5
    got = _bf16_read(q, cache.k.float(), cache.v.float(), cache.length, sm,
                     sliding_window, return_lse)
    if return_lse:
        return got[0].to(q.dtype), got[1]
    return got.to(q.dtype)


def verify_attention_bf16(q: torch.Tensor, cache: BF16KVCache, *, base_len,
                          scale: Optional[float] = None,
                          sliding_window: Optional[int] = None
                          ) -> torch.Tensor:
    """kq-query verify read over the bf16 cache (ref
    ``quant_attention_ref.py:445``): appends write position t at index t,
    so the final buffers below L_i = L0 + i + 1 are what step i saw.
    Each query runs :func:`decode_attention_bf16`'s operations; the fp32
    casts of K/V are shared."""
    kq = q.shape[2]
    sm = scale if scale is not None else q.shape[-1] ** -0.5
    k, v = cache.k.float(), cache.v.float()
    lengths = _per_query_lengths(base_len, kq)
    return torch.cat([
        _bf16_read(q[:, :, i:i + 1], k, v, lengths[:, i].to(q.device), sm,
                   sliding_window) for i in range(kq)], dim=2).to(q.dtype)


def decode_attention_bf16_blockwise(q: torch.Tensor, cache: BF16KVCache, *,
                                    scale: Optional[float] = None,
                                    sliding_window: Optional[int] = None,
                                    kv_block: int = 512,
                                    return_lse: bool = False):
    """The bf16 read under the int4 read's tiling (BLOCKWISE), so that a
    backend sweep measures both policies the same way.  A masked position
    weighs exactly zero: a row of length 0 yields a zero output, as the
    GATHER read's empty-row guard does, where the reference's tiles give
    the mean of the masked values; every row with a valid position gets
    the reference's result (a masked weight there is exp(-1e30 - m) = 0,
    or is scaled away by the next valid tile's zero correction)."""
    B, Hq, _, d = q.shape
    Hkv = cache.k.shape[1]
    G = Hq // Hkv
    sm = scale if scale is not None else d ** -0.5
    dev = q.device
    length = _per_row(cache.length, 5)
    qg = q.float().reshape(B, Hkv, G, 1, d) * sm

    m, l, acc = _online_init(B, Hkv, G, d, dev)
    for j, start, blk in _tiles(cache.s_max, kv_block):
        kj = cache.k[:, :, start:start + blk].float()
        vj = cache.v[:, :, start:start + blk].float()
        kv_pos = start + torch.arange(blk, device=dev)
        mask = (kv_pos < length) & (kv_pos >= j * blk)
        if sliding_window is not None:
            mask = mask & (kv_pos > length - 1 - sliding_window)
        logits = torch.where(
            mask, torch.einsum("bhgqd,bhsd->bhgqs", qg, kj), NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqs,bhsd->bhgqd", p, vj)
        m = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l[..., None]).reshape(B, Hq, 1, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, Hq, 1)
    return out
