"""Plain PyTorch versions of kernels B1 and B2 (port of ``_kernel_impl``
/ ``_unpack_dequant`` in ``repro/kernels/quant_attention/quant_attention.py``
and of ``quant_decode_attention_paged_fwd`` (:228)).

Follows the TPU kernel tile by tile: an online softmax over ``blk``-token
tiles of the packed cache (tiles at or past a row's ``packed_len``
skipped, positions masked ``< packed_len`` with the -1e30 sentinel), then
the fp32 residual window (positions ``packed_len + i``, masked ``<
total_len``) folded in with the same update, then ``acc / max(l,
1e-30)`` and, on request, the log-sum-exp ``m + log(max(l, 1e-30))``
(an empty row keeps the -1e30 sentinel).  B2's plain version resolves
every token through the page table and then applies B1's plain math, one
tile per page as the reference's paged kernel does.
"""
from __future__ import annotations

import torch

__all__ = ["quant_decode_attention_ref", "quant_decode_attention_paged_ref",
           "paged_rows", "unpack_dequant", "row_lengths"]

NEG = -1e30


def unpack_dequant(p: torch.Tensor, scales: torch.Tensor, group: int
                   ) -> torch.Tensor:
    """(..., n, d//2) uint8 + (..., n, d//group) -> (..., n, d) f32."""
    pi = p.to(torch.int32)
    low, high = pi & 0xF, (pi >> 4) & 0xF
    low = torch.where(low >= 8, low - 16, low)
    high = torch.where(high >= 8, high - 16, high)
    d = p.shape[-1] * 2
    codes = torch.stack([low, high], dim=-1).reshape(*p.shape[:-1], d)
    y = codes.float().reshape(*p.shape[:-1], d // group, group)
    return (y * scales[..., None]).reshape(*p.shape[:-1], d)


def row_lengths(x, rows: int, device) -> torch.Tensor:
    """A scalar (int or 0-d tensor) or per-row (rows,) length -> (rows,) i32."""
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    return t.reshape(-1).expand(rows)


def quant_decode_attention_ref(
    q_eff: torch.Tensor,  # (BH, G, d) f32: rotation, 1/lam_k, scale folded
    k_packed: torch.Tensor,  # (BH, S, d//2) uint8
    k_scales: torch.Tensor,  # (BH, S, d//group) f32
    v_packed: torch.Tensor,
    v_scales: torch.Tensor,
    k_residual: torch.Tensor,  # (BH, W, d) f32, rotated space
    v_residual: torch.Tensor,
    packed_len,  # int, () or (BH,)
    total_len,
    *,
    group: int = 32,
    blk: int = 256,
    return_lse: bool = False,
):
    """Returns out_rot (BH, G, d) f32 in rotated space, and with
    ``return_lse`` the (BH, G) f32 log-sum-exp of each head's scores."""
    BH, G, d = q_eff.shape
    S, W = k_packed.shape[1], k_residual.shape[1]
    dev = q_eff.device
    plen = row_lengths(packed_len, BH, dev)
    tlen = row_lengths(total_len, BH, dev)
    q = q_eff.float()
    m = torch.full((BH, G, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((BH, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((BH, G, d), dtype=torch.float32, device=dev)

    def update(m, l, acc, kd, vd, mask):  # kd/vd (BH, n, d), mask (BH, n)
        logits = q @ kd.transpose(-1, -2)  # (BH, G, n)
        logits = torch.where(mask[:, None, :], logits, NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        return (m_new, l * corr + p.sum(dim=-1, keepdim=True),
                acc * corr + p @ vd)

    blk = min(blk, S)
    n_live = -(-int(plen.max()) // blk) if BH else 0
    for s in range(n_live):
        lo, hi = s * blk, min(s * blk + blk, S)
        kd = unpack_dequant(k_packed[:, lo:hi], k_scales[:, lo:hi], group)
        vd = unpack_dequant(v_packed[:, lo:hi], v_scales[:, lo:hi], group)
        pos = torch.arange(lo, hi, device=dev)
        new = update(m, l, acc, kd, vd, pos[None, :] < plen[:, None])
        live = (lo < plen)[:, None, None]  # skip tiles past packed_len
        m, l, acc = (torch.where(live, a, b) for a, b in zip(new, (m, l, acc)))

    pos_r = plen[:, None] + torch.arange(W, device=dev)[None, :]
    m, l, acc = update(m, l, acc, k_residual.float(), v_residual.float(),
                       pos_r < tlen[:, None])
    l = l.clamp_min(1e-30)
    if return_lse:
        return acc / l, (m + torch.log(l))[..., 0]
    return acc / l


def paged_rows(pool: torch.Tensor, page_table: torch.Tensor,
               n_kv_heads: int) -> torch.Tensor:
    """A flattened pool ``(n_pages*H, page_size, c)`` seen per row: token t
    of row ``r = b*H + h`` is ``pool[page_table[b, t // ps]*H + h,
    t % ps]``.  Returns ``(B*H, MP*ps, c)``."""
    H = n_kv_heads
    B, MP = page_table.shape
    ps, c = pool.shape[1], pool.shape[2]
    h = torch.arange(H, device=pool.device)
    blocks = page_table.long()[:, None, :] * H + h[None, :, None]  # (B,H,MP)
    return pool[blocks.reshape(B * H, MP)].reshape(B * H, MP * ps, c)


def quant_decode_attention_paged_ref(
    q_eff: torch.Tensor,  # (BH, G, d) f32
    k_packed: torch.Tensor,  # (n_pages*H, page_size, d//2) uint8 pool
    k_scales: torch.Tensor,  # (n_pages*H, page_size, d//group) f32 pool
    v_packed: torch.Tensor,
    v_scales: torch.Tensor,
    k_residual: torch.Tensor,  # (BH, W, d) f32, per row (not paged)
    v_residual: torch.Tensor,
    packed_len: torch.Tensor,  # (BH,) int32
    total_len: torch.Tensor,  # (BH,) int32
    page_table: torch.Tensor,  # (B, MP) int32
    *,
    group: int = 32,
    n_kv_heads: int = 1,
) -> torch.Tensor:
    """Returns out_rot (BH, G, d) f32 in rotated space."""
    pools = (paged_rows(t, page_table, n_kv_heads)
             for t in (k_packed, k_scales, v_packed, v_scales))
    return quant_decode_attention_ref(
        q_eff, *pools, k_residual, v_residual, packed_len, total_len,
        group=group, blk=k_packed.shape[1])
