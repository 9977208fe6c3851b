"""The yardstick's arithmetic: the chip's peaks and the FLOPs and bytes
the work needs, counted from the shapes alone (what the algorithm needs,
not what a kernel happens to do).  ``tests/test_perfbench_costs.py``
holds these counts to the port's census (``repro_torch.launch.cost``) at
a reduced size.

Peaks: one NVIDIA H100 SXM, the data sheet's dense rates at 700 W.
"""
from __future__ import annotations

import math

__all__ = ["PEAK_BF16_FLOPS", "PEAK_FP32_FLOPS", "PEAK_HBM_BYTES_S",
           "weight_flops_per_token", "unembed_flops", "decode_token_flops",
           "prefill_flops", "b2_step_work"]

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12


def weight_flops_per_token(cfg) -> float:
    """2 x the parameters of every layer's projections and FFN (SwiGLU:
    three matrices), per token; no unembedding."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
    ffn = (3 if cfg.ffn_activation in ("swiglu", "geglu") else 2) \
        * d * cfg.d_ff
    return 2.0 * cfg.n_layers * (attn + ffn)


def unembed_flops(cfg) -> float:
    return 2.0 * cfg.d_model * cfg.vocab_size


def decode_token_flops(cfg, length: int) -> float:
    """One row's decode step at cache length ``length`` (the new token
    included): the weights, the unembedding, and q.k and p.v over the
    row's tokens in every layer."""
    attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * length
    return weight_flops_per_token(cfg) + unembed_flops(cfg) + attn


def prefill_flops(cfg, n: int) -> float:
    """A monolithic prefill of ``n`` tokens: the weights for every token,
    causal attention (query i reads i + 1 keys), the unembedding of the
    last token."""
    attn = 2.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * n * (n + 1)
    return n * weight_flops_per_token(cfg) + attn + unembed_flops(cfg)


def b2_step_work(cfg, lengths, *, group: int = 32, window: int = 16,
                 page_size: int = 16) -> tuple[float, float]:
    """(FLOPs, bytes) B2 needs for one decode step of one layer over rows
    at cache ``lengths`` (the new token included): each row's K and V
    codes and scales below its packed length, its live window tokens in
    fp32, its page-table entries, the folded fp32 query and the fp32
    output, each read or written once; a multiply-add for q.k and one for
    p.v per (query head, token)."""
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    g = cfg.n_heads // hkv
    flops = nbytes = 0.0
    for L in lengths:
        L = int(L)
        plen = L - L % window
        per_head = (2 * plen * (hd // 2 + (hd // group) * 4)
                    + 2 * (L - plen) * hd * 4 + 2 * g * hd * 4)
        nbytes += hkv * per_head + math.ceil(L / page_size) * 4
        flops += 4.0 * hkv * g * hd * L
    return flops, nbytes
