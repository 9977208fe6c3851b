"""Mixture-of-Experts FFN with GShard capacity-bounded one-hot dispatch
(port of ``repro/models/moe.py:24-122``): top-k routing over groups of
tokens, then dispatch and combine as dense einsums.

Tokens are flattened and cut into G groups of ``gs`` tokens, ``gs`` the
largest divisor of B·S that is at most ``group_size``; every expert takes
at most C tokens a group (:func:`capacity`).  Earlier routing ranks claim
slots first (every token's first choice before any second choice), and a
(token, expert) pair past C is dropped.  Ties between router
probabilities go to the lower expert index, as ``jax.lax.top_k`` does.
Every step is a fixed-shape tensor op (no boolean indexing, no
``nonzero``, no ``.item()``), so a decode step with this layer can be
captured in a CUDA graph.  The expert products are plain batched matrix
products: the reference runs them as einsums outside any Pallas kernel.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import common

__all__ = ["capacity", "group_size", "moe_init", "moe_apply", "top_k",
           "Routes", "routing"]

# When a list, each ``moe_apply`` appends its count of dropped (token,
# expert) pairs as a 0-d device tensor; None (the default) records
# nothing, so the step reads nothing back.
drop_log: Optional[list] = None

_ROUTES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_routes", default=None)


class Routes:
    """The routed-first shares (E,) fp32 of the MoE layers of one forward,
    in call order (``log``).  Given ``shares``, each layer takes the next
    of them in place of its own tokens' shares in the load-balancing loss:
    the data-parallel train step gives every shard the mean over the
    shards, so that each shard's loss carries its part of the global
    batch's (``launch/sharded_train.py``).  The shares carry no gradient
    either way.  One forward, no recomputation (remat off)."""

    def __init__(self, shares: Optional[list] = None):
        self.log: list = []
        self._shares = None if shares is None else list(shares)

    def take(self, me: torch.Tensor) -> torch.Tensor:
        self.log.append(me.detach())
        if self._shares is None:
            return me
        if not self._shares:
            raise RuntimeError("more MoE layers ran than shares were given")
        return self._shares.pop(0)

    @property
    def used_up(self) -> bool:
        return not self._shares


@contextlib.contextmanager
def routing(routes: Routes):
    """``routes`` records (and, given shares, sets) the routed-first shares
    of every ``moe_apply`` in the block."""
    tok = _ROUTES.set(routes)
    try:
        yield routes
    finally:
        _ROUTES.reset(tok)


def capacity(group_tokens: int, top_k: int, n_experts: int,
             factor: float) -> int:
    """Slots per expert and group: ceil(gs·K/E·factor) rounded up to a
    multiple of 4, at least 4."""
    c = math.ceil(group_tokens * top_k / n_experts * factor)
    return max(4, -(-c // 4) * 4)


def group_size(n_tokens: int, max_group: int) -> int:
    """The largest divisor of ``n_tokens`` that is at most ``max_group``
    (1 for a prime count above it)."""
    gs = min(max_group, n_tokens)
    while n_tokens % gs:
        gs -= 1
    return gs


def moe_init(generator: torch.Generator, d_model: int, mcfg, device="cpu"):
    E, de = mcfg.n_experts, mcfg.d_expert

    def experts(d_in, d_out):  # in place: one fp32 copy of the leaf at most
        w = torch.randn((E, d_in, d_out), generator=generator,
                        dtype=torch.float32, device=device)
        return {"w": w.div_(math.sqrt(d_in)).to(common.PARAM_DTYPE)}

    return {
        "router": common.dense_init(generator, d_model, E, scale=0.02,
                                    device=device),
        "w_gate": experts(d_model, de),
        "w_up": experts(d_model, de),
        "w_down": experts(de, d_model),
    }


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot over ``n`` classes; a value outside [0, n) gives a row
    of zeros (``jax.nn.one_hot``'s rule)."""
    return (x[..., None] == torch.arange(n, device=x.device,
                                         dtype=x.dtype)).float()


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_combine(top_idx, top_vals, E: int, C: int):
    """combine and dispatch (G, S, E, C) fp32: rank-major capacity, so
    every token's first choice claims a slot before any second choice."""
    G, S, K = top_idx.shape
    oh = _one_hot(top_idx, E)  # (G, S, K, E)
    ohk = oh.transpose(1, 2).reshape(G, K * S, E)
    pos = torch.cumsum(ohk, dim=1) - ohk  # each (k, s)'s slot in its expert
    keep = (pos < C) * ohk
    if drop_log is not None:
        drop_log.append(ohk.sum() - keep.sum())
    pos_c = _one_hot(pos, C) * keep[..., None]  # (G, K*S, E, C)
    pos_c = pos_c.reshape(G, K, S, E, C).transpose(1, 2)  # (G, S, K, E, C)
    combine = (pos_c * top_vals[..., None, None]).sum(dim=2)
    return combine, pos_c.sum(dim=2)


def moe_apply(p, x: torch.Tensor, mcfg):
    """x (B, S, d) bf16 -> (y (B, S, d) bf16, aux load-balancing loss, a
    0-d fp32 tensor)."""
    B, S, d = x.shape
    gs = group_size(B * S, mcfg.group_size)
    G = B * S // gs
    E, K = mcfg.n_experts, mcfg.top_k
    C = capacity(gs, K, E, mcfg.capacity_factor)

    xg = x.reshape(G, gs, d)
    logits = common.dense(p["router"], xg).float()  # (G, gs, E)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k(probs, K)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    combine, dispatch = _dispatch_combine(top_idx, top_vals, E, C)
    combine = combine.to(common.COMPUTE_DTYPE)
    dispatch = dispatch.to(common.COMPUTE_DTYPE)
    # tokens to expert slots (G, E, C, d), the experts' SwiGLU, and back
    xe = common.einsum_f32("gsec,gsd->gecd", dispatch, xg).to(
        common.COMPUTE_DTYPE)
    gate = common.einsum_f32("gecd,edf->gecf", xe, p["w_gate"]["w"])
    up = common.einsum_f32("gecd,edf->gecf", xe, p["w_up"]["w"])
    h = (F.silu(gate) * up).to(common.COMPUTE_DTYPE)
    ye = common.einsum_f32("gecf,efd->gecd", h, p["w_down"]["w"]).to(
        common.COMPUTE_DTYPE)
    y = common.einsum_f32("gsec,gecd->gsd", combine, ye)

    # GShard aux loss: E * sum_e (share routed first to e * mean prob of e)
    me = _one_hot(top_idx[..., 0], E).mean(dim=(0, 1))
    routes = _ROUTES.get()
    if routes is not None:
        me = routes.take(me)
    pe = probs.mean(dim=(0, 1))
    aux = E * (me * pe).sum()
    return y.reshape(B, S, d).to(common.COMPUTE_DTYPE), aux
