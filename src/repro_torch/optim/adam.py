"""Minimal functional AdamW and schedules on nested containers of tensors
(port of ``repro/optim/adam.py``).

Not ``torch.optim.Adam``: this keeps the reference's arithmetic (eps added
after the bias-corrected sqrt, bias corrections as fp32 powers, moments in
fp32, the update computed in fp32 and cast back to the param dtype), so a
step on the same gradients gives the reference's params.  Params and
gradients are dicts, lists and tuples of tensors (the port's LM params);
every function returns new tensors and runs without autograd.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["AdamState", "adam_init", "adam_update", "clip_by_global_norm",
           "global_norm", "clip_scale", "cosine_schedule", "tree_map",
           "tree_leaves"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of ``tree`` (and the same places of
    ``rest``), keeping the dict/list/tuple/NamedTuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [tree_map(fn, v, *(r[i] for r in rest))
                    for i, v in enumerate(tree)]
        # a NamedTuple takes its fields positionally, not as one iterable
        return (type(tree)(*children) if hasattr(tree, "_fields")
                else type(tree)(children))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any  # first moments, fp32, same structure as the params
    nu: Any  # second moments


def adam_init(params) -> AdamState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    dev = tree_leaves(params)[0].device
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                     tree_map(zeros, params), tree_map(zeros, params))


@torch.no_grad()
def adam_update(grads, state: AdamState, params, *, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """One AdamW step: (new params, new state).  ``lr`` is a float or a
    callable of the (1-based) step tensor."""
    step = state.step + 1
    stepf = step.float()
    lr_t = lr(step) if callable(lr) else torch.as_tensor(
        lr, dtype=torch.float32, device=step.device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                 device=step.device)
    b1c = 1.0 - f32(b1) ** stepf
    b2c = 1.0 - f32(b2) ** stepf
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
    nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g.float().square(),
                  state.nu, grads)

    def upd(p, m, n):
        delta = (m / b1c) / ((n / b2c).sqrt() + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr_t * delta).to(p.dtype)

    return tree_map(upd, params, mu, nu), AdamState(step, mu, nu)


@torch.no_grad()
def global_norm(grads) -> torch.Tensor:
    """The fp32 L2 norm of all the leaves together."""
    return torch.stack([g.float().square().sum()
                        for g in tree_leaves(grads)]).sum().sqrt()


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm ``gn`` down to ``max_norm``
    (1 when it is below)."""
    return torch.clamp(max_norm / gn.clamp_min(1e-12), max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(fp32 grads scaled so their global L2 norm is at most ``max_norm``,
    the norm before scaling); fp32 as the reference's promotion makes
    them."""
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup to ``base_lr``, then cosine decay to 0 at ``total``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return lr
