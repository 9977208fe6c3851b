"""Mamba2 (SSD) block (port of ``repro/models/ssm.py``): the chunked
parallel form for prefill and training, the O(1) recurrent update for
decode.  The minimal SSD algorithm of Mamba-2 [arXiv:2405.21060] with a
scalar-identity A per head.  The reference has no Pallas kernel here, so
this stays plain PyTorch.

State per layer (:class:`SSMState`):
    ssd  : (B, H, N, P) fp32
    conv : (B, conv_dim, d_conv - 1) compute dtype, as the reference keeps it

The functions return new states; the model copies them into its cache's
tensors in place (a captured decode step replays fixed addresses).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import common

__all__ = ["mamba2_init", "mamba2_forward", "mamba2_decode", "init_ssm_state",
           "SSMState", "HEADDIM"]

HEADDIM = 64  # P, the SSD head width


class SSMState(NamedTuple):
    ssd: torch.Tensor  # (B, H, N, P) fp32
    conv: torch.Tensor  # (B, conv_dim, d_conv - 1)


def _dims(cfg):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    nheads = inner // HEADDIM
    conv_dim = inner + 2 * s.n_groups * s.d_state
    return inner, nheads, conv_dim


def mamba2_init(generator: torch.Generator, cfg, device="cpu"):
    s = cfg.ssm
    d = cfg.d_model
    inner, H, conv_dim = _dims(cfg)
    d_in_proj = 2 * inner + 2 * s.n_groups * s.d_state + H
    f32 = dict(dtype=torch.float32, device=device)
    # dt bias such that softplus(dt_bias) spans [1e-3, 1e-1]
    u = torch.rand(H, generator=generator, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    conv_w = torch.randn((s.d_conv, conv_dim), generator=generator, **f32)
    a = torch.rand(H, generator=generator, **f32) * 15.0 + 1.0
    return {
        "in_proj": common.dense_init(generator, d, d_in_proj, device=device),
        "conv_w": (conv_w * 0.1).to(common.PARAM_DTYPE),
        "conv_b": torch.zeros(conv_dim, dtype=common.PARAM_DTYPE,
                              device=device),
        "dt_bias": dt_bias,
        "A_log": torch.log(a),
        "D": torch.ones(H, **f32),
        "norm": common.rmsnorm_init(inner, device),
        "out_proj": common.dense_init(generator, inner, d, device=device),
    }


def init_ssm_state(cfg, batch: int, device="cpu") -> SSMState:
    s = cfg.ssm
    _, H, conv_dim = _dims(cfg)
    return SSMState(
        ssd=torch.zeros((batch, H, s.d_state, HEADDIM), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((batch, conv_dim, s.d_conv - 1),
                         dtype=common.COMPUTE_DTYPE, device=device))


def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    inner, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return (zxbcdt[..., :inner], zxbcdt[..., inner:2 * inner + 2 * gn],
            zxbcdt[..., 2 * inner + 2 * gn:])


def _conv1d(p, xBC, cfg, conv_state=None):
    """Causal depthwise conv along time, xBC (B, L, conv_dim): (silu(y),
    the new conv state)."""
    d_conv = cfg.ssm.d_conv
    w = p["conv_w"].float()  # (d_conv, conv_dim)
    b = p["conv_b"].float()
    x = xBC.float()
    if conv_state is not None:  # decode: L == 1
        window = torch.cat([conv_state.float().transpose(1, 2), x], dim=1)
        y = (window * w).sum(dim=1)[:, None]
        new_state = window[:, 1:].transpose(1, 2).to(common.COMPUTE_DTYPE)
        return F.silu(y + b), new_state
    L = x.shape[1]
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    y = pad[:, 0:L] * w[0]
    for i in range(1, d_conv):
        y = y + pad[:, i:i + L] * w[i]
    new_state = pad[:, L:L + d_conv - 1].transpose(1, 2).to(
        common.COMPUTE_DTYPE)
    return F.silu(y + b), new_state


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Decay exponents out[..., i, j] = sum_{k=j+1..i} dA_k for i >= j,
    -inf otherwise; dA (..., c), fp32."""
    c = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((c, c), dtype=torch.bool, device=dA.device).tril()
    return diff.masked_fill(~mask, -torch.inf)


def _ssd_chunked(x, dt, A, B, C, chunk: int, init_state):
    """SSD scan (ref ``ssm.py:113-164``).  x (b, l, h, p), dt (b, l, h), A
    (h,), B/C (b, l, n) [n_groups = 1], all fp32.  Returns (y (b, l, h, p),
    final state (b, h, n, p))."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    dA = dtc * A  # (b, nc, c, h), negative
    cums = torch.cumsum(dA, dim=2)

    # intra-chunk: scores[i, j] = C_i . B_j * exp(cums_i - cums_j); the
    # decay tensor (b, nc, h, c, c) is fp32, as the reference's
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))
    CB = torch.einsum("bzin,bzjn->bzij", Cc, Bc)
    scores = CB[:, :, None] * Lmat  # (b, nc, h, i, j)
    xdt = xc * dtc[..., None]  # (b, nc, j, h, p)
    y_intra = torch.einsum("bzhij,bzjhp->bzihp", scores, xdt)

    # chunk summaries: S_z = sum_j exp(cums_end - cums_j) dt_j B_j (x) x_j
    decay_end = torch.exp(cums[:, :, -1:, :] - cums)  # (b, nc, c, h)
    Sz = torch.einsum("bzcn,bzchp->bzhnp", Bc,
                      xc * (decay_end * dtc)[..., None])
    lam = torch.exp(cums[:, :, -1])  # (b, nc, h) total chunk decay

    state = init_state
    prev = []
    for z in range(nc):  # emit the state before each chunk
        prev.append(state)
        state = state * lam[:, z, :, None, None] + Sz[:, z]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, n, p)

    # inter-chunk: y_i += C_i . (prev_state * exp(cums_i))
    y_inter = torch.einsum("bzcn,bzhnp->bzchp", Cc, prev_states) \
        * torch.exp(cums)[..., None]
    return (y_intra + y_inter).reshape(b, l, h, p), state


def _gate_norm_out(p, y, z, cfg):
    y = (y * F.silu(z.float())).to(common.COMPUTE_DTYPE)
    y = common.rmsnorm(p["norm"], y, eps=cfg.norm_eps)
    return common.dense(p["out_proj"], y)


def mamba2_forward(p, u: torch.Tensor, cfg,
                   state: Optional[SSMState] = None):
    """Full-sequence forward, u (B, L, d) -> (y, new state).  The SSD
    chunk is ``min(cfg.ssm.chunk, L)`` and must divide L: padding would
    change the final state, so another length raises (as the reference
    asserts)."""
    s = cfg.ssm
    inner, H, _ = _dims(cfg)
    B_, L, _ = u.shape
    if state is None:
        state = init_ssm_state(cfg, B_, u.device)
    chunk = min(s.chunk, L)
    if L % chunk:
        raise ValueError(f"mamba2_forward: L={L} is no multiple of the SSD "
                         f"chunk {chunk} (the reference asserts this; "
                         f"padding would change the final state)")
    zxbcdt = common.dense(p["in_proj"], u)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC, conv_state = _conv1d(p, xBC, cfg)
    x = xBC[..., :inner].reshape(B_, L, H, HEADDIM)
    Bmat = xBC[..., inner:inner + s.d_state]
    Cmat = xBC[..., inner + s.d_state:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, final = _ssd_chunked(x, dt, A, Bmat, Cmat, chunk, state.ssd)
    y = y + p["D"][None, None, :, None] * x
    y = _gate_norm_out(p, y.reshape(B_, L, inner), z, cfg)
    return y, SSMState(final, conv_state)


def mamba2_decode(p, u: torch.Tensor, cfg, state: SSMState):
    """Single-token recurrent update, u (B, 1, d) -> (y, new state)."""
    s = cfg.ssm
    inner, H, _ = _dims(cfg)
    B_ = u.shape[0]
    zxbcdt = common.dense(p["in_proj"], u)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC, conv_state = _conv1d(p, xBC, cfg, conv_state=state.conv)
    x = xBC[:, 0, :inner].reshape(B_, H, HEADDIM)
    Bmat = xBC[:, 0, inner:inner + s.d_state]
    Cmat = xBC[:, 0, inner + s.d_state:]
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)
    upd = (dt[:, :, None, None] * Bmat[:, None, :, None]) * x[:, :, None, :]
    new_ssd = state.ssd * dA[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cmat, new_ssd)
    y = y + p["D"][None, :, None] * x
    y = _gate_norm_out(p, y.reshape(B_, 1, inner), z, cfg)
    return y, SSMState(new_ssd, conv_state)
