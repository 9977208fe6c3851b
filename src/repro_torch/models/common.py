"""Shared model primitives: norms, dense layers, RoPE, embeddings (port of
``repro/models/common.py``).

Params are nested dicts of tensors, stored bf16 (norm scales fp32);
activations are bf16 with fp32 accumulation.  ``REPRO_BF16_DOTS`` is the
reference's switch with the reference's default: unset or ``0`` runs
every matmul on fp32 operands (what the CPU tests compare), ``1`` on bf16
operands with fp32 accumulation (the TPU-faithful mode; on a card it runs
the tensor cores).  It is read once, at import; :func:`dot_mode`
switches it for a block (the quality measurements run on fp32 operands,
as the reference's benchmarks do, inside a process that serves in bf16).
"""
from __future__ import annotations

import contextlib
import os

import torch

PARAM_DTYPE = torch.bfloat16
COMPUTE_DTYPE = torch.bfloat16
BF16_DOTS = os.environ.get("REPRO_BF16_DOTS", "0") == "1"

__all__ = [
    "PARAM_DTYPE",
    "COMPUTE_DTYPE",
    "BF16_DOTS",
    "dot_mode",
    "dot_operand",
    "matmul",
    "einsum_f32",
    "dense_init",
    "dense",
    "rmsnorm_init",
    "rmsnorm",
    "layernorm_init",
    "layernorm",
    "embed_init",
    "rope_freqs",
    "apply_rope",
    "sinusoidal_positions",
]


@contextlib.contextmanager
def dot_mode(bf16: bool):
    """Run the block with bf16 (True) or fp32 (False) matmul operands."""
    global BF16_DOTS
    saved, BF16_DOTS = BF16_DOTS, bf16
    try:
        yield
    finally:
        BF16_DOTS = saved


def dot_operand(x: torch.Tensor) -> torch.Tensor:
    """Cast a matmul operand to the active dot dtype."""
    return x.to(COMPUTE_DTYPE if BF16_DOTS else torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on the active dot dtype, fp32 accumulation, fp32 result.  In
    bf16 mode the product comes back rounded to bf16 once (the reference
    rounds it when ``dense`` casts to bf16, so only the tied unembedding,
    whose logits stay fp32 there, sees the extra rounding)."""
    return (dot_operand(a) @ dot_operand(b)).float()


def einsum_f32(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` on the active dot dtype, fp32 accumulation, fp32
    result (ref ``common.py:53-58``); in bf16 mode the product is rounded
    to bf16 once, as :func:`matmul`'s."""
    return torch.einsum(spec, *(dot_operand(o) for o in ops)).float()


def _randn(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def dense_init(generator: torch.Generator, d_in: int, d_out, *,
               bias: bool = False, scale: float | None = None, device="cpu"):
    """He-ish init (std ``scale`` if given); d_out may be a tuple for fused
    multi-head weights.  Layout (d_in, *d_out), as the reference."""
    d_out_t = (d_out,) if isinstance(d_out, int) else tuple(d_out)
    std = scale if scale is not None else d_in ** -0.5
    p = {"w": (_randn(generator, (d_in, *d_out_t), device) * std).to(
        PARAM_DTYPE)}
    if bias:
        p["b"] = torch.zeros(d_out_t, dtype=PARAM_DTYPE, device=device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, *d_out) -> (..., *d_out) bf16."""
    w = p["w"]
    y = matmul(x, w.reshape(w.shape[0], -1))
    y = y.reshape(*x.shape[:-1], *w.shape[1:])
    if "b" in p:
        y = y + p["b"].float()
    return y.to(COMPUTE_DTYPE)


def rmsnorm_init(d: int, device="cpu"):
    return {"scale": torch.zeros(d, dtype=torch.float32, device=device)}


def rmsnorm(p, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the (1 + w) parameterization (zeros-init scale)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"])).to(COMPUTE_DTYPE)


def layernorm_init(d: int, device="cpu"):
    return {"scale": torch.zeros(d, dtype=torch.float32, device=device),
            "bias": torch.zeros(d, dtype=torch.float32, device=device)}


def layernorm(p, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the (1 + w) parameterization and a bias (ref
    ``common.py:120-131``): fp32 inside, compute dtype out."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return ((1.0 + p["scale"]) * y + p["bias"]).to(COMPUTE_DTYPE)


def embed_init(generator: torch.Generator, vocab: int, d: int, device="cpu"):
    return {"embedding": (_randn(generator, (vocab, d), device) * 0.02).to(
        PARAM_DTYPE)}


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """(head_dim // 2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotary embedding (ref ``repro/models/common.py:145-158``).
    x: (B, H, S, d); positions: (S,) shared, or (B, S) per row."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * inv  # (S, d/2) or (B, S, d/2)
    if positions.dim() == 2:
        ang = ang[:, None]  # (B, 1, S, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device="cpu") -> torch.Tensor:
    """Whisper-style sinusoidal absolute positions (n, d) fp32 (ref
    ``common.py:161-167``: computed in float64, then rounded)."""
    pos = torch.arange(n, dtype=torch.float64)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float64)[None, :]
    ang = pos / (10000 ** (2 * dim / d))
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return out.to(device=device, dtype=torch.float32)
