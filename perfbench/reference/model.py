"""A decoder-only LM with an int4-SRFT KV cache, written plainly in float32
from the published descriptions: the model (GQA attention with RoPE,
optional per-head query/key RMSNorm, SwiGLU FFN, RMSNorm; InternLM2 and
Qwen3 as their config.json files state them) and the paper's cache
("When Quantization Is Free", §7.1-7.2).

The cache: each key and value vector of a head is rotated by the SRFT
y = pack(rfft_ortho(s * x)) (s: the layer's random signs; pack keeps the
real parts, sqrt(2) times the inner real and imaginary parts), cut into
groups of 32 coordinates, and each group stored as int4 codes
clip(round_half_even(y / scale), -7, 7) with scale = max|y| / 7.  The 16
newest tokens stay exact in a window that is quantized when it fills, so
a read at cache length L sees tokens [0, L - L mod 16) quantized and the
rest exact.  Prompt tokens attend the exact K/V (the prefill reads no
cache); a decoded token is appended before it attends.  The rotation is
orthonormal, so scores and outputs are computed in the original basis on
dequantized-and-rotated-back vectors.

Given a prompt of P tokens and the n tokens served after it, ``logits``
returns the (n, V) logits that predict each served token: position
P - 1 (the prefill) and the n - 1 decode steps after it.

``gemm="fp8"`` is the control: every weight product takes both operands
through float8 e4m3 (per-row scales for activations, per-column for
weights), the precision step below bf16 that a faster path would tempt.

Norm weights are given as ``scale`` with weight = 1 + scale.  float32
products run without TF32 (the caller turns it off).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Hyper", "hyper_from_config", "srft_matrix", "quantize_rows",
           "Reference"]

QMAX = 7
GROUP = 32
WINDOW = 16
F8_MAX = 448.0


class Hyper(dict):
    __getattr__ = dict.__getitem__


def hyper_from_config(cj: dict) -> Hyper:
    """The sizes the reference needs, read from a config.json-style dict."""
    heads = cj["num_attention_heads"]
    return Hyper(
        n_layers=cj["num_hidden_layers"], d=cj["hidden_size"], heads=heads,
        kv_heads=cj["num_key_value_heads"],
        hd=cj.get("head_dim") or cj["hidden_size"] // heads,
        vocab=cj["vocab_size"], eps=float(cj["rms_norm_eps"]),
        theta=float(cj["rope_theta"]), qk_norm=bool(cj.get("qk_norm")),
        tie=bool(cj.get("tie_word_embeddings", False)))


def srft_matrix(signs: torch.Tensor) -> torch.Tensor:
    """B (d, d) float32 with B @ x = pack(rfft_ortho(signs * x)), built in
    float64 with numpy."""
    s = signs.double().cpu().numpy()
    d = s.shape[0]
    y = np.fft.rfft(np.diag(s), axis=0, norm="ortho")  # column i: e_i
    rt2 = np.sqrt(2.0)
    b = np.concatenate([y.real[:1], rt2 * y.real[1:d // 2],
                        y.real[d // 2:d // 2 + 1], rt2 * y.imag[1:d // 2]])
    return torch.from_numpy(b).float().to(signs.device)


def quantize_rows(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (..., d) -> its int4-SRFT round trip in the original basis."""
    y = x @ b.T
    g = y.reshape(*y.shape[:-1], -1, GROUP)
    scale = g.abs().amax(-1, keepdim=True).clamp_min(1e-12) / QMAX
    q = torch.round(g / scale).clamp(-QMAX, QMAX) * scale
    return q.reshape(y.shape) @ b


def _f8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim, keepdim=True).clamp_min(1e-12) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    def __init__(self, hyper: Hyper, params: dict, signs: torch.Tensor, *,
                 gemm: str = "fp32", q_block: int = 1024):
        self.h, self.p, self.signs = hyper, params, signs
        self.gemm = gemm
        self.q_block = q_block

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float().reshape(w.shape[0], -1)
        if self.gemm == "fp8":
            return _f8(x, -1) @ _f8(w, 0)
        return x @ w

    def _rms(self, x, scale):
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.h.eps)
        return y * (1.0 + scale.float())

    def _rope(self, x, pos):
        hd = x.shape[-1]
        inv = 1.0 / (self.h.theta ** (torch.arange(
            0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = pos[:, None].float() * inv  # (T, hd/2)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _attend(self, q, k, v, kq, vq, n_prompt):
        """q (T, H, hd); k, v and their quantized round trips (T, Hkv,
        hd).  Query i >= n_prompt reads keys j < (i+1) - (i+1) mod W from
        the quantized copies, the rest exact; prompt queries read exact."""
        h = self.h
        T, G = q.shape[0], h.heads // h.kv_heads
        scale = h.hd ** -0.5
        out = torch.empty_like(q)
        kk, vv = k.transpose(0, 1), v.transpose(0, 1)  # (Hkv, T, hd)
        kqq, vqq = kq.transpose(0, 1), vq.transpose(0, 1)
        for i0 in range(0, T, self.q_block):
            i1 = min(T, i0 + self.q_block)
            qi = q[i0:i1].reshape(i1 - i0, h.kv_heads, G, h.hd)
            qi = qi.permute(1, 2, 0, 3) * scale  # (Hkv, G, n, hd)
            s = torch.einsum("hgnd,hjd->hgnj", qi, kk[:, :i1])
            ii = torch.arange(i0, i1, device=q.device)[:, None]
            jj = torch.arange(i1, device=q.device)[None, :]
            causal = jj <= ii
            quant = (ii >= n_prompt) & (jj < (ii + 1) - (ii + 1) % WINDOW)
            if bool(quant.any()):
                sq = torch.einsum("hgnd,hjd->hgnj", qi, kqq[:, :i1])
                s = torch.where(quant, sq, s)
            p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
            if bool(quant.any()):
                pq = p * quant
                o = torch.einsum("hgnj,hjd->hgnd", p - pq, vv[:, :i1]) \
                    + torch.einsum("hgnj,hjd->hgnd", pq, vqq[:, :i1])
            else:
                o = torch.einsum("hgnj,hjd->hgnd", p, vv[:, :i1])
            out[i0:i1] = o.permute(2, 0, 1, 3).reshape(i1 - i0, h.heads, h.hd)
        return out

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, n_prompt: int) -> torch.Tensor:
        """tokens (T,): the prompt and the served tokens but the last.
        Returns (T - n_prompt + 1, V) float32 logits of positions
        n_prompt - 1 .. T - 1."""
        h, p = self.h, self.p
        T = tokens.shape[0]
        x = p["embed"]["embedding"][tokens].float()
        pos = torch.arange(T, device=x.device)
        for i, blk in enumerate(p["blocks"]):
            a = blk["attn"]
            y = self._rms(x, blk["ln_attn"]["scale"])
            q = self._mm(y, a["wq"]["w"]).reshape(T, h.heads, h.hd)
            k = self._mm(y, a["wk"]["w"]).reshape(T, h.kv_heads, h.hd)
            v = self._mm(y, a["wv"]["w"]).reshape(T, h.kv_heads, h.hd)
            if "b" in a["wq"]:
                q = q + a["wq"]["b"].float()
                k = k + a["wk"]["b"].float()
                v = v + a["wv"]["b"].float()
            if h.qk_norm:
                q = self._rms(q, a["q_norm"]["scale"])
                k = self._rms(k, a["k_norm"]["scale"])
            q, k = self._rope(q, pos), self._rope(k, pos)
            bk, bv = srft_matrix(self.signs[i, 0]), srft_matrix(self.signs[i, 1])
            o = self._attend(q, k, v, quantize_rows(k, bk),
                             quantize_rows(v, bv), n_prompt)
            x = x + self._mm(o.reshape(T, -1), a["wo"]["w"])
            f = blk["ffn"]
            y = self._rms(x, blk["ln_ffn"]["scale"])
            x = x + self._mm(F.silu(self._mm(y, f["w_gate"]["w"]))
                             * self._mm(y, f["w_up"]["w"]), f["w_down"]["w"])
        y = self._rms(x[n_prompt - 1:], p["ln_final"]["scale"])
        w = p["embed"]["embedding"].T if h.tie else p["unembed"]["w"]
        return self._mm(y, w)
