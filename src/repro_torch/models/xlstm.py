"""xLSTM blocks [arXiv:2405.04517] (port of ``repro/models/xlstm.py``):
mLSTM (matrix memory, parallelizable) and sLSTM (scalar memory with
recurrent gate weights).  Exponential gating with the max-stabilizer m_t,
a per-head RMS norm on the recurrent output, up/down projections with a
SiLU side gate.  The reference has no Pallas kernel here, so this stays
plain PyTorch.

States (NamedTuples of fp32 tensors):
    mLSTM: C (B, H, dk, dv), n (B, H, dk), m (B, H)
    sLSTM: c, n, h, m (B, H, dh)

The functions return new states; the model copies them into its cache's
tensors in place (a captured decode step replays fixed addresses).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models import common

__all__ = [
    "mlstm_init", "mlstm_forward", "mlstm_decode", "init_mlstm_state",
    "slstm_init", "slstm_forward", "slstm_decode", "init_slstm_state",
    "MLSTMState", "SLSTMState", "mlstm_dims",
]


class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, H, dk, dv)
    n: torch.Tensor  # (B, H, dk)
    m: torch.Tensor  # (B, H)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dh)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def mlstm_dims(cfg):
    x = cfg.xlstm
    inner = x.expand * cfg.d_model
    H = cfg.n_heads
    dv = inner // H
    dk = int(dv * x.qk_dim_factor)
    return inner, H, dk, dv


def mlstm_init(generator: torch.Generator, cfg, device="cpu"):
    inner, H, dk, dv = mlstm_dims(cfg)
    d = cfg.d_model

    def mk(d_in, d_out, bias=False):
        return common.dense_init(generator, d_in, d_out, bias=bias,
                                 device=device)

    return {
        "up": mk(d, 2 * inner),
        "wq": mk(inner, (H, dk)),
        "wk": mk(inner, (H, dk)),
        "wif": mk(inner, 2 * H, bias=True),
        "wo": mk(inner, inner, bias=True),
        "norm": common.rmsnorm_init(dv, device),
        "down": mk(inner, d),
    }


def init_mlstm_state(cfg, batch: int, device="cpu") -> MLSTMState:
    _, H, dk, dv = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros((batch, H, dk, dv), **f32),
                      n=torch.zeros((batch, H, dk), **f32),
                      m=torch.full((batch, H), -torch.inf, **f32))


def _mlstm_step(state: MLSTMState, q, k, v, ipre, fpre):
    """One recurrent step: q, k (B, H, dk), v (B, H, dv), gate preacts
    (B, H).  A first step's m = -inf makes the forget term drop out."""
    C, n, m = state
    m_new = torch.maximum(fpre + m, ipre)
    i_g = torch.exp(ipre - m_new)
    f_g = torch.exp(fpre + m - m_new)
    C_new = f_g[..., None, None] * C + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f_g[..., None] * n + i_g[..., None] * k
    denom = torch.clamp((n_new * q).sum(-1).abs(), min=1.0)
    h = torch.einsum("bhk,bhkv->bhv", q, C_new) / denom[..., None]
    return MLSTMState(C_new, n_new, m_new), h


def _mlstm_inputs(p, x_m, cfg):
    _, H, dk, dv = mlstm_dims(cfg)
    B, L, _ = x_m.shape
    q = common.dense(p["wq"], x_m).float() / float(dk) ** 0.5
    k = common.dense(p["wk"], x_m).float() / float(dk) ** 0.5
    v = x_m.reshape(B, L, H, dv).float()
    i_f = common.dense(p["wif"], x_m).float()
    ipre, fpre = i_f[..., :H], F.logsigmoid(i_f[..., H:])
    return q, k, v, ipre, fpre


def _mlstm_out(p, hs, o, z, cfg):
    """Per-head norm, output gate, SiLU side gate, down projection."""
    B, L = hs.shape[:2]
    h = common.rmsnorm(p["norm"], hs.to(common.COMPUTE_DTYPE),
                       eps=cfg.norm_eps)
    h = h.float().reshape(B, L, -1) * o
    y = h * F.silu(z.float())
    return common.dense(p["down"], y.to(common.COMPUTE_DTYPE))


def mlstm_forward(p, x: torch.Tensor, cfg,
                  state: Optional[MLSTMState] = None):
    """Full-sequence mLSTM, x (B, L, d) -> (y, state).  The
    chunkwise-parallel form when the chunk divides L and L exceeds it,
    the sequential form otherwise, as the reference dispatches."""
    inner, H, dk, dv = mlstm_dims(cfg)
    B, L, _ = x.shape
    if state is None:
        state = init_mlstm_state(cfg, B, x.device)
    up = common.dense(p["up"], x)
    x_m, z = up[..., :inner], up[..., inner:]
    q, k, v, ipre, fpre = _mlstm_inputs(p, x_m, cfg)
    o = torch.sigmoid(common.dense(p["wo"], x_m).float())
    chunk = cfg.xlstm.chunk
    if chunk and L % chunk == 0 and L > chunk:
        hs, state = _mlstm_chunkwise(q, k, v, ipre, fpre, state, chunk)
    else:
        out = []
        for t in range(L):
            state, h = _mlstm_step(state, q[:, t], k[:, t], v[:, t],
                                   ipre[:, t], fpre[:, t])
            out.append(h)
        hs = torch.stack(out, dim=1)  # (B, L, H, dv)
    return _mlstm_out(p, hs, o, z, cfg), state


def _mlstm_chunkwise(q, k, v, ipre, fpre, state: MLSTMState, chunk: int):
    """Chunkwise-parallel mLSTM with the exact max-stabilized math of the
    reference (``xlstm.py:155-217``); q/k (B, L, H, dk), v (B, L, H, dv),
    gate preacts (B, L, H) with fpre in log-sigmoid space.  Returns (h
    (B, L, H, dv), state)."""
    B, L, H, dk = q.shape
    dv = v.shape[-1]
    c = chunk
    nc = L // c
    qc = q.reshape(B, nc, c, H, dk).permute(1, 0, 3, 2, 4)
    kc = k.reshape(B, nc, c, H, dk).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nc, c, H, dv).permute(1, 0, 3, 2, 4)
    ic = ipre.reshape(B, nc, c, H).permute(1, 0, 3, 2)
    fc = fpre.reshape(B, nc, c, H).permute(1, 0, 3, 2)
    tril = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    C_p, n_p, m_p = state
    hs = []
    for z in range(nc):
        qj, kj, vj, ij, fj = qc[z], kc[z], vc[z], ic[z], fc[z]
        b = torch.cumsum(fj, dim=-1)  # (B, H, c)
        a = ij - b
        m_intra = b + torch.cummax(a, dim=-1).values
        m = torch.maximum(m_p[..., None] + b, m_intra)
        expo = a[..., None, :] + (b - m)[..., :, None]  # (B, H, j, t)
        D = torch.exp(expo.masked_fill(~tril, -torch.inf))
        inter = torch.exp(m_p[..., None] + b - m)  # (B, H, c)
        scores = torch.einsum("bhjd,bhtd->bhjt", qj, kj) * D
        h_num = torch.einsum("bhjt,bhtv->bhjv", scores, vj) \
            + inter[..., None] * torch.einsum("bhjd,bhdv->bhjv", qj, C_p)
        n_vec = torch.einsum("bhjt,bhtd->bhjd", D, kj) \
            + inter[..., None] * n_p[..., None, :]
        den = torch.clamp((qj * n_vec).sum(-1).abs(), min=1.0)
        hs.append(h_num / den[..., None])  # (B, H, c, dv)
        C_p = inter[..., -1, None, None] * C_p + torch.einsum(
            "bhtd,bhtv->bhdv", kj * D[..., -1, :, None], vj)
        n_p, m_p = n_vec[..., -1, :], m[..., -1]
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, L, H, dv)
    return h, MLSTMState(C_p, n_p, m_p)


def mlstm_decode(p, x: torch.Tensor, cfg, state: MLSTMState):
    """x (B, 1, d) -> (y (B, 1, d), state)."""
    inner = mlstm_dims(cfg)[0]
    up = common.dense(p["up"], x)
    x_m, z = up[..., :inner], up[..., inner:]
    q, k, v, ipre, fpre = _mlstm_inputs(p, x_m, cfg)
    o = torch.sigmoid(common.dense(p["wo"], x_m).float())
    state, h = _mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], ipre[:, 0],
                           fpre[:, 0])
    return _mlstm_out(p, h[:, None], o, z, cfg), state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_dims(cfg):
    inner = cfg.xlstm.expand * cfg.d_model
    H = cfg.n_heads
    return inner, H, inner // H


def slstm_init(generator: torch.Generator, cfg, device="cpu"):
    inner, H, dh = slstm_dims(cfg)
    d = cfg.d_model
    rg = torch.randn((4, H, dh, dh), generator=generator,
                     dtype=torch.float32, device=device) / float(dh) ** 0.5
    return {
        "up": common.dense_init(generator, d, 2 * inner, device=device),
        "wg": common.dense_init(generator, inner, 4 * inner, bias=True,
                                device=device),
        # four gates (i, f, z, o) from the input; block-diagonal
        # recurrent weights
        "rg": rg.to(common.PARAM_DTYPE),
        "norm": common.rmsnorm_init(dh, device),
        "down": common.dense_init(generator, inner, d, device=device),
    }


def init_slstm_state(cfg, batch: int, device="cpu") -> SLSTMState:
    _, H, dh = slstm_dims(cfg)

    def z():
        return torch.zeros((batch, H, dh), dtype=torch.float32,
                           device=device)

    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((batch, H, dh), -torch.inf,
                                   dtype=torch.float32, device=device))


def _slstm_step(rg: torch.Tensor, state: SLSTMState, g_in: torch.Tensor):
    """One step; g_in (B, 4 * inner) are the input gate preacts, ``rg`` the
    recurrent weights in fp32."""
    B = g_in.shape[0]
    H, dh = rg.shape[1], rg.shape[2]
    rec = torch.einsum("bhd,ghde->gbhe", state.h, rg)  # (4, B, H, dh)
    g = g_in.reshape(B, 4, H, dh).transpose(0, 1) + rec
    ipre, zpre, opre = g[0], g[2], g[3]
    fpre = F.logsigmoid(g[1])
    m_new = torch.maximum(fpre + state.m, ipre)
    i_g = torch.exp(ipre - m_new)
    f_g = torch.exp(fpre + state.m - m_new)  # a -inf first m gives 0
    c_new = f_g * state.c + i_g * torch.tanh(zpre)
    n_new = f_g * state.n + i_g
    h_new = torch.sigmoid(opre) * c_new / torch.clamp(n_new, min=1.0)
    return SLSTMState(c_new, n_new, h_new, m_new), h_new


def _slstm_chunk(p, rg, state: SLSTMState, x_chunk: torch.Tensor):
    """Steps over one chunk (B, c, inner), its gate projection computed
    locally: (state, hs (B, c, H, dh) bf16)."""
    g_all = common.dense(p["wg"], x_chunk).float()
    hs = []
    for t in range(x_chunk.shape[1]):
        state, h = _slstm_step(rg, state, g_all[:, t])
        hs.append(h.to(common.COMPUTE_DTYPE))
    return state, torch.stack(hs, dim=1)


def _slstm_out(p, h, z, cfg):
    B, L = h.shape[:2]
    h = common.rmsnorm(p["norm"], h.to(common.COMPUTE_DTYPE),
                       eps=cfg.norm_eps)
    y = h.float().reshape(B, L, -1) * F.silu(z.float())
    return common.dense(p["down"], y.to(common.COMPUTE_DTYPE))


def slstm_forward(p, x: torch.Tensor, cfg,
                  state: Optional[SLSTMState] = None):
    """Full-sequence sLSTM, x (B, L, d) -> (y, state).  Inherently
    sequential: the chunked form (the chunk divides L and L exceeds it)
    projects the gates a chunk at a time and, when autograd records,
    recomputes each chunk in the backward pass, as the reference's
    ``jax.checkpoint`` does; the values are the sequential form's."""
    inner = slstm_dims(cfg)[0]
    B, L, _ = x.shape
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    up = common.dense(p["up"], x)
    x_s, z = up[..., :inner], up[..., inner:]
    rg = p["rg"].float()
    chunk = cfg.xlstm.chunk
    if chunk and L % chunk == 0 and L > chunk:
        hs = []
        for j in range(L // chunk):
            xj = x_s[:, j * chunk:(j + 1) * chunk]
            if torch.is_grad_enabled():
                state, h = torch.utils.checkpoint.checkpoint(
                    _slstm_chunk, p, rg, state, xj, use_reentrant=False)
            else:
                state, h = _slstm_chunk(p, rg, state, xj)
            hs.append(h)
        h = torch.cat(hs, dim=1)
    else:
        g_all = common.dense(p["wg"], x_s).float()
        out = []
        for t in range(L):
            state, ht = _slstm_step(rg, state, g_all[:, t])
            out.append(ht)
        h = torch.stack(out, dim=1)
    return _slstm_out(p, h, z, cfg), state


def slstm_decode(p, x: torch.Tensor, cfg, state: SLSTMState):
    inner = slstm_dims(cfg)[0]
    up = common.dense(p["up"], x)
    x_s, z = up[..., :inner], up[..., inner:]
    g = common.dense(p["wg"], x_s).float()[:, 0]
    state, h = _slstm_step(p["rg"].float(), state, g)
    return _slstm_out(p, h[:, None], z, cfg), state
