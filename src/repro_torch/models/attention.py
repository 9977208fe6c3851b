"""Attention layer: GQA + RoPE + optional qk_norm / QKV bias, with the two
serving paths behind the cache-policy protocol (port of
``repro/models/attention.py``):

  * full sequence : blockwise flash attention on the raw bf16 K/V
                    (training and eval, optionally through the KV
                    round-trip hook); a prefill also writes K/V into the
                    cache through its policy; ``causal=False`` for an
                    encoder, and ``cross_kv`` for a cross-attention (K/V
                    from the encoder states, no RoPE, not causal);
  * prompt chunk  : one C-token slice of a prompt (chunked prefill): its
                    K/V go into raw bf16 side buffers, which its queries
                    attend, and into the cache through the policy;
  * decode        : one token -- append first, then attend, so the new
                    token is read back from the residual window; with
                    ``cross=True`` the cache is read-only (a
                    cross-attention's, filled once at prefill);
  * verify        : k tokens of a speculative pass -- the same k appends
                    a sequential decode makes, then one k-query read.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.cache_api import AttendBackend, CacheState
from repro_torch.models import common
from repro_torch.models.flash import flash_attention

__all__ = ["attention_init", "attention_forward", "attention_prefill_chunk",
           "attention_decode", "attention_verify"]


def attention_init(generator: torch.Generator, cfg, device="cpu"):
    d, hd = cfg.d_model, cfg.head_dim

    def mk(d_in, d_out, bias=False):
        return common.dense_init(generator, d_in, d_out, bias=bias,
                                 device=device)

    p = {
        "wq": mk(d, (cfg.n_heads, hd), cfg.qkv_bias),
        "wk": mk(d, (cfg.n_kv_heads, hd), cfg.qkv_bias),
        "wv": mk(d, (cfg.n_kv_heads, hd), cfg.qkv_bias),
        "wo": mk(cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = common.rmsnorm_init(hd, device)
        p["k_norm"] = common.rmsnorm_init(hd, device)
    return p


def _project_qkv(p, x, cfg, positions):
    """x (B,S,d) -> q (B,Hq,S,hd), k/v (B,Hkv,S,hd), post qk_norm + RoPE."""
    q = common.dense(p["wq"], x).permute(0, 2, 1, 3)
    k = common.dense(p["wk"], x).permute(0, 2, 1, 3)
    v = common.dense(p["wv"], x).permute(0, 2, 1, 3)
    if cfg.qk_norm:
        q = common.rmsnorm(p["q_norm"], q, eps=cfg.norm_eps)
        k = common.rmsnorm(p["k_norm"], k, eps=cfg.norm_eps)
    if cfg.rope_theta:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _merge_heads(p, o):
    """(B,H,S,hd) -> (B,S,d) via the output projection."""
    B, H, S, hd = o.shape
    return common.dense(p["wo"], o.permute(0, 2, 1, 3).reshape(B, S, H * hd))


def attention_forward(p, x: torch.Tensor, cfg, *, q_offset: int = 0,
                      causal: bool = True, kv_block: int = 1024,
                      kv_roundtrip: Optional[Callable] = None,
                      cache: Optional[CacheState] = None,
                      cross_kv: Optional[torch.Tensor] = None,
                      return_kv: bool = False):
    """Full-sequence attention (train, eval or prefill; ref
    ``attention.py:77-126``).  Returns (y, cache), or (y, cache, (k, v))
    with ``return_kv`` (activations for lambda calibration).  The cache,
    if given, is filled in place through its policy.  ``kv_roundtrip``
    maps (k, v) -> (k~, v~) before attention: the paper's hook
    measurement, quantization error on every read.  ``cross_kv`` (B,
    S_enc, d) makes it a cross-attention: queries from x, K/V projected
    from ``cross_kv``, no RoPE, not causal."""
    S = x.shape[1]
    if cross_kv is not None:
        q = common.dense(p["wq"], x).permute(0, 2, 1, 3)
        k = common.dense(p["wk"], cross_kv).permute(0, 2, 1, 3)
        v = common.dense(p["wv"], cross_kv).permute(0, 2, 1, 3)
        causal = False
    else:
        positions = q_offset + torch.arange(S, device=x.device)
        q, k, v = _project_qkv(p, x, cfg, positions)
    if kv_roundtrip is not None:
        k, v = kv_roundtrip(k, v)
    if cache is not None:
        cache = cache.policy.prefill(cache, k, v)
    o = flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                        kv_block=kv_block, scale=cfg.head_dim ** -0.5)
    if return_kv:
        return _merge_heads(p, o), cache, (k, v)
    return _merge_heads(p, o), cache


def attention_prefill_chunk(p, x: torch.Tensor, cfg, cache: CacheState,
                            raw_k: torch.Tensor, raw_v: torch.Tensor, *,
                            offset: "int | torch.Tensor",
                            kv_block: int = 1024):
    """Chunked-prefill attention (ref ``attention.py:128-173``): x (B, C,
    d) at absolute positions [offset, offset + C); ``offset`` may be a
    device scalar.  The chunk's K/V are written twice, in place: into the
    raw bf16 side buffers ``raw_k`` / ``raw_v`` (B, Hkv, S_prompt, hd) and
    into the cache through ``policy.prefill_chunk``.  The queries attend
    the raw buffers, so they see the K/V a monolithic prefill uses, and
    chunking moves neither a hidden state nor a cache byte; positions at
    or past offset + C are excluded by the causal mask.  Returns (y,
    cache)."""
    C = x.shape[1]
    positions = offset + torch.arange(C, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    raw_k.index_copy_(2, positions, k.to(raw_k.dtype))
    raw_v.index_copy_(2, positions, v.to(raw_v.dtype))
    cache = cache.policy.prefill_chunk(cache, k, v)
    o = flash_attention(q, raw_k, raw_v, q_offset=offset, kv_block=kv_block,
                        scale=cfg.head_dim ** -0.5)
    return _merge_heads(p, o), cache


def attention_decode(p, x: torch.Tensor, cfg, cache: CacheState, *,
                     position: "int | torch.Tensor" = 0, cross: bool = False,
                     kv_block: int = 512,
                     backend: "AttendBackend | str | None" = None,
                     active: Optional[torch.Tensor] = None):
    """One-token decode (x (B, 1, d)) against the cache (ref
    ``repro/models/attention.py:176-212``).  ``position`` is a shared int
    or, for a ragged cache, per-row (B,): each row RoPE-rotates at its own
    position; ``active`` (B,) bool keeps finished rows' lengths still.
    ``cross=True`` reads a read-only cache (a cross-attention's, filled
    at prefill): no projection of K/V, no append.  Returns (y, cache)."""
    if cross:
        q = common.dense(p["wq"], x).permute(0, 2, 1, 3)
    else:
        if isinstance(position, int):
            pos = torch.tensor([position], device=x.device)
        else:
            pos = position[:, None]
        q, k, v = _project_qkv(p, x, cfg, pos)
        cache = cache.policy.update(cache, k, v, active=active)
    o = cache.policy.attend(q, cache, scale=cfg.head_dim ** -0.5,
                            backend=backend, kv_block=kv_block)
    return _merge_heads(p, o), cache


def attention_verify(p, x: torch.Tensor, cfg, cache: CacheState, *,
                     position: "int | torch.Tensor", kv_block: int = 512,
                     backend: "AttendBackend | str | None" = None,
                     active: Optional[torch.Tensor] = None, snap=None):
    """Speculative verify (ref ``repro/models/attention.py:215``): x (B, k,
    d) is the current token and k - 1 drafts.  Token j RoPE-rotates at
    ``position + j`` (per row when ``position`` is (B,)); the k appends
    are the unrolled ``policy.update`` calls of a sequential decode, so
    the cache holds its bytes, and ``policy.verify_attend`` reads each
    query against its own prefix.  ``snap`` is a previous
    ``snapshot_rows`` result whose buffers this pass's snapshot is copied
    into (fixed addresses under a captured pass).  Returns (y, cache,
    snap); the caller rolls rejected drafts back with
    ``policy.truncate_rows(cache, new_length, snap)``."""
    kq = x.shape[1]
    j = torch.arange(kq, device=x.device)
    pos = position + j if isinstance(position, int) \
        else position[:, None] + j[None, :]
    q, k, v = _project_qkv(p, x, cfg, pos)
    snap = cache.policy.snapshot_rows(cache, into=snap)
    for i in range(kq):
        cache = cache.policy.update(cache, k[:, :, i:i + 1],
                                    v[:, :, i:i + 1], active=active)
    o = cache.policy.verify_attend(q, cache, snap,
                                   scale=cfg.head_dim ** -0.5,
                                   backend=backend, kv_block=kv_block)
    return _merge_heads(p, o), cache, snap
