"""The training step: forward, backward, clip, AdamW (port of
``repro/launch/steps.py:20-43``), the prefill step (``:46-59``) and the
decode step (``:62-71``).

The reference differentiates with ``jax.value_and_grad``; here autograd
runs through the port's plain modules (training has no Pallas kernel, so
it needs no backward kernel).  Params are plain tensors: each step makes
them require grad, and the update returns new tensors that do not.  Run
it outside ``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adam import (
    adam_init,
    adam_update,
    clip_by_global_norm,
    tree_leaves,
    tree_map,
)

__all__ = ["init_train_state", "make_train_step", "make_prefill_step",
           "make_decode_step"]


def init_train_state(model, generator: torch.Generator):
    """(params, Adam state) for ``model``."""
    params = model.init(generator)
    return params, adam_init(params)


def make_train_step(model, *, lr=3e-4, clip: float = 1.0):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``lr`` is a float or a schedule ``fn(step) -> lr``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def train_step(params, opt_state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(params)
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        del it  # its list would keep the raw grads alive through the update
        grads, gnorm = clip_by_global_norm(grads, clip)
        step_lr = lr_fn(opt_state.step)
        params = tree_map(lambda p: p.detach(), params)
        params, opt_state = adam_update(grads, opt_state, params, lr=step_lr)
        out = {"loss": loss.detach(), "grad_norm": gnorm, "lr": step_lr,
               **{k: v.detach() for k, v in metrics.items()}}
        return params, opt_state, out

    return train_step


def make_prefill_step(model):
    """``prefill_step(params, batch, cache) -> (logits, cache)``: an audio
    batch carries ``frames`` and ``tokens``, a vlm batch may carry
    ``patches``."""
    family = model.cfg.family

    def prefill_step(params, batch, cache):
        if family == "audio":
            return model.prefill(params, batch["frames"], batch["tokens"],
                                 cache)
        if family == "vlm":
            return model.prefill(params, batch["tokens"], cache,
                                 patches=batch.get("patches"))
        return model.prefill(params, batch["tokens"], cache)

    return prefill_step


def make_decode_step(model, *, backend=None):
    """``decode_step(params, token, cache) -> (logits, cache)``: one token
    ``(B, 1)`` appended and read through ``backend`` (an
    ``AttendBackend``, closed over as the reference's static argument)."""

    def decode_step(params, token, cache):
        return model.decode_step(params, token, cache, backend=backend)

    return decode_step
