"""Controlled outlier-channel injection (port of ``repro/core/outliers.py``;
the paper's §5.6 mechanism).

The paper traces Qwen2.5's 4-bit per-token catastrophe to one dominant
coordinate in layer-0 K.  The small stand-ins do not grow such channels,
so the benchmarks inject one by a reparameterization that keeps the
full-precision function:

  K outlier: scale the RoPE channel pair (c, c + d/2) of ``wk`` by alpha
             and the same pair of ``wq`` by 1/alpha.  RoPE rotates the
             pair (split-half convention) and a scalar commutes with the
             2x2 rotation, so every score q.k is unchanged in exact
             arithmetic, while the stored K has a dominant pair.
  V outlier: scale channel c of ``wv`` by alpha and divide the matching
             input rows of ``wo`` by alpha (V has no RoPE).

Requires qk_norm=False (a post-projection norm breaks the invariance).
"""
from __future__ import annotations

import torch

__all__ = ["inject_kv_outliers"]


def _scaled(w: torch.Tensor, index, factor: float) -> torch.Tensor:
    """A new tensor: ``w`` with ``w[index]`` multiplied by ``factor``.  The
    factor is rounded to ``w``'s dtype first, as the reference's
    weakly-typed scalar is, so the product rounds once, identically."""
    out = w.clone()
    out[index] = out[index] * torch.tensor(factor, dtype=w.dtype,
                                           device=w.device)
    return out


def inject_kv_outliers(params: dict, *, head_dim: int, channel: int = 2,
                       alpha: float = 20.0, inject_k: bool = True,
                       inject_v: bool = True) -> dict:
    """Params with an outlier channel in every layer's attention and the
    full-precision function kept.  ``params`` is the port's LM params
    (``blocks`` a per-layer list); every patched weight is a new tensor,
    so neither the input params nor another layer are touched."""
    if not 0 <= channel < head_dim // 2:
        raise ValueError(f"channel {channel} not in [0, {head_dim // 2})")
    pair = [channel, channel + head_dim // 2]

    def patch_attn(attn: dict) -> dict:
        attn = dict(attn)
        if inject_k:
            for name, f in (("wk", alpha), ("wq", 1.0 / alpha)):
                layer = dict(attn[name])
                for leaf in ("w", "b"):
                    if leaf in layer:  # (d_in, H, hd) and (H, hd)
                        layer[leaf] = _scaled(layer[leaf], (..., pair), f)
                attn[name] = layer
        if inject_v:
            wv = dict(attn["wv"])
            for leaf in ("w", "b"):
                if leaf in wv:
                    wv[leaf] = _scaled(wv[leaf], (..., channel), alpha)
            attn["wv"] = wv
            wo = attn["wo"]["w"]  # (Hq * hd, d_model)
            n_rows, d_model = wo.shape
            wo_r = _scaled(wo.reshape(n_rows // head_dim, head_dim, d_model),
                           (slice(None), channel), 1.0 / alpha)
            attn["wo"] = dict(attn["wo"], w=wo_r.reshape(wo.shape))
        return attn

    out = dict(params)
    out["blocks"] = [dict(b, attn=patch_attn(b["attn"]))
                     for b in params["blocks"]]
    return out
