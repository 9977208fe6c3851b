"""Sharded training, single-controller: the counterpart of the reference's
``jax.jit(step)`` on params placed by ``param_specs`` and batches by
``batch_specs`` (``repro/launch/train.py:91-110``,
``tests/test_distributed.py:29-61``).

The state.  ``shard_train_state`` places ``(params, AdamState)`` on a mesh
(``launch/mesh.py``): every leaf becomes a ``partitioning.Sharded`` with
one piece on each mesh device.  A param leaf takes its spec from
``layer_param_specs`` (layout ``baseline``, or ``sp_fsdp``: the FSDP rules
of ``act_sharding.fsdp_param_specs``); Adam's moments take their param's
spec and its step count is replicated, as the reference's ``adam_init``
on sharded params gives them.

A step (``make_sharded_train_step``) is data parallel over the data axes
(('pod', 'data') when a pod axis exists):

  1. the batch is split along dim 0 as ``batch_specs`` assigns it; a batch
     that does not divide is replicated and computed once, on the lead;
  2. for each data index, the params are gathered whole on that index's
     device (the mesh device at index 0 of the other axes), and the
     forward and backward run on the index's rows;
  3. each shard's cross entropy is weighted by its share of the global
     count of loss-mask targets, so the weighted sum is ``LM.loss``'s
     masked mean over the whole batch and the gradients add up to its
     gradient;
  4. the shards' gradients are summed in index order in fp32 on the lead
     device (the all-gather of the sum), clipped by their global norm and
     split onto each leaf's pieces (the reduce-scatter);
  5. AdamW runs on each device's pieces.

The 'model' axis, and whatever part of 'data' a param's spec uses, splits
only the storage of the params and the Adam state; compute splits over
the data axes alone (tensor-parallel compute over 'model' is ROADMAP D).
A mesh of one data index runs the single-device step's arithmetic, so its
state equals ``steps.make_train_step``'s bit for bit.

A MoE groups the flattened batch's tokens (``models/moe.py``).  A shard's
groups are the global batch's exactly when the global group size divides
the tokens a shard holds; otherwise the step raises.  Its load-balancing
loss multiplies two means over the batch (the routed-first shares and
the router probabilities), so the mean of the shards' own losses is not
the global one: a first forward without gradients collects each shard's
shares, and every shard's loss then uses their mean (``moe.Routes``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch import partitioning as pt
from repro_torch.launch.mesh import data_axes
from repro_torch.models import moe
from repro_torch.optim.adam import (
    AdamState,
    adam_update,
    clip_scale,
    global_norm,
    tree_leaves,
    tree_map,
)

__all__ = ["train_state_specs", "shard_train_state", "split_batch",
           "data_devices", "make_sharded_train_step"]


def train_state_specs(params, mesh, *, layout: str = "baseline"):
    """(param specs, AdamState of specs) for ``params``' per-layer tree."""
    specs = pt.layer_param_specs(params, mesh, layout=layout)
    return specs, AdamState(pt.P(), specs, specs)


def shard_train_state(params, opt: AdamState, mesh, *,
                      layout: str = "baseline"):
    """``(params, opt)`` placed on ``mesh`` by ``train_state_specs``: every
    leaf a ``Sharded``."""
    pspecs, ospecs = train_state_specs(params, mesh, layout=layout)
    return pt.shard_tree(params, pspecs, mesh), pt.shard_tree(opt, ospecs,
                                                              mesh)


def data_devices(mesh) -> list:
    """One device per data index (row-major over ``data_axes``): the mesh
    device at that index and at index 0 of every other axis."""
    axes = data_axes(mesh)
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for k in range(int(np.prod(sizes))):
        coord = dict(zip(axes, np.unravel_index(k, sizes)))
        out.append(mesh.devices[tuple(int(coord.get(a, 0))
                                      for a in mesh.axis_names)])
    return out


def split_batch(batch: dict, mesh) -> list:
    """[(device, rows)] a data index: dim 0 of every leaf split over the
    data axes where ``batch_specs`` splits it, else the whole batch once
    on the lead device."""
    specs = dict(pt.flatten_with_path(pt.batch_specs(batch, mesh)))
    devices = data_devices(mesh)
    n = len(devices)
    if n == 1 or any(not s or s[0] is None for s in specs.values()):
        return [(mesh.lead, {k: v.to(mesh.lead) for k, v in batch.items()})]
    rows = next(iter(batch.values())).shape[0] // n
    return [(d, {k: v[i * rows:(i + 1) * rows].to(d)
                 for k, v in batch.items()})
            for i, d in enumerate(devices)]


def _targets(batch: dict) -> torch.Tensor:
    """The count of targets ``LM.loss`` averages over: the mask's ones at
    positions 1.., or every position past the first."""
    mask = batch.get("loss_mask")
    if mask is None:
        B, S = batch["tokens"].shape
        return torch.tensor(float(B * (S - 1)))
    return mask[:, 1:].float().sum()


def _check_moe_groups(cfg, batch: dict, n: int) -> None:
    B, S = batch["tokens"].shape
    if batch.get("patches") is not None:
        S += batch["patches"].shape[1]
    gs = moe.group_size(B * S, cfg.moe.group_size)
    if (B // n * S) % gs:
        raise ValueError(
            f"{cfg.name}: the MoE groups the batch's {B * S} tokens in "
            f"groups of {gs}, which do not divide a data shard's "
            f"{B // n * S} tokens ({n} shards), so a shard would route "
            f"other groups than the whole batch does; make a shard's "
            f"tokens a multiple of {gs}")


def _route_shares(model, params, shards: list, lead) -> list:
    """The mean over the shards of each MoE layer's routed-first shares,
    from one forward per shard without gradients."""
    logs = []
    with torch.no_grad():
        for dev, b in shards:
            p = pt.gather_tree(params, dev)
            with moe.routing(moe.Routes()) as routes:
                model.forward_aux(p, b["tokens"], patches=b.get("patches"))
            logs.append(routes.log)
            del p
    n = len(logs)
    return [sum(log[i].to(lead) for log in logs) / n
            for i in range(len(logs[0]))]


def make_sharded_train_step(model, mesh, *, lr=3e-4, clip: float = 1.0,
                            layout: str = "baseline"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the signature and metrics of ``steps.make_train_step``;
    params and state are ``Sharded`` trees (plain ones are placed first,
    by ``layout``'s specs).  ``lr`` is a float or a schedule
    ``fn(step) -> lr``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)
    cfg = model.cfg
    lead = mesh.lead

    def train_step(params, opt_state, batch):
        if not isinstance(tree_leaves(params)[0], pt.Sharded):
            params, opt_state = shard_train_state(params, opt_state, mesh,
                                                  layout=layout)
        shards = split_batch(batch, mesh)
        n = len(shards)
        if cfg.moe is not None and n > 1:
            _check_moe_groups(cfg, batch, n)
        counts = [_targets(b).to(lead) for _, b in shards]
        total = torch.stack(counts).sum().clamp_min(1.0)
        shares = (_route_shares(model, params, shards, lead)
                  if cfg.moe is not None and n > 1 else None)

        acc = ce = aux = None
        for k, (dev, b) in enumerate(shards):
            w = (counts[k] / total).to(dev)
            p = tree_map(lambda s: pt.gather_tree(s, dev).requires_grad_(True),
                         params)
            leaves = tree_leaves(p)
            routes = moe.Routes(None if shares is None
                                else [s.to(dev) for s in shares])
            with moe.routing(routes):
                _, m = model.loss(p, b)
            assert routes.used_up
            obj = w * m["ce"]
            if cfg.moe is not None:
                obj = obj + (0.01 / n) * m["aux"]
            grads = torch.autograd.grad(obj, leaves, allow_unused=True)
            grads = [torch.zeros(t.shape, dtype=torch.float32, device=lead)
                     if g is None else g.float().to(lead)
                     for t, g in zip(leaves, grads)]
            if acc is None:
                acc = grads
            else:
                for a, g in zip(acc, grads):
                    a += g
            part_ce = (w * m["ce"]).detach().to(lead)
            ce = part_ce if ce is None else ce + part_ce
            part_aux = m["aux"].detach().to(lead)
            aux = part_aux if aux is None else aux + part_aux
            del p, leaves, grads, m, obj
        aux = aux / n

        gn = global_norm(acc)
        scale = clip_scale(gn, clip)
        p_leaves = tree_leaves(params)
        g_leaves = []
        for j, s in enumerate(p_leaves):
            g_leaves.append(pt.place(acc[j] * scale, s.spec, mesh))
            acc[j] = None
        step_lr = lr_fn(opt_state.step.pieces.flat[0])
        new_p, new_mu, new_nu, new_step = _adam_by_device(
            g_leaves, opt_state, p_leaves, lr_fn, mesh)

        params = _like(params, new_p)
        opt_state = AdamState(new_step, _like(opt_state.mu, new_mu),
                              _like(opt_state.nu, new_nu))
        loss = ce if cfg.moe is None else ce + 0.01 * aux
        out = {"loss": loss, "grad_norm": gn, "lr": step_lr, "ce": ce,
               "aux": aux}
        return params, opt_state, out

    return train_step


def _like(tree, leaves: list):
    """``tree``'s structure holding ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _adam_by_device(g_leaves, opt_state: AdamState, p_leaves, lr_fn, mesh):
    """``adam_update`` once per mesh device, on the pieces that device
    holds; returns the new leaves as ``Sharded`` (params, mu, nu) and the
    new step count."""
    mu, nu = tree_leaves(opt_state.mu), tree_leaves(opt_state.nu)
    shape = mesh.devices.shape
    out = [[np.empty(shape, dtype=object) for _ in p_leaves]
           for _ in range(3)]
    step = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        def at(leaves):
            return [s.pieces[idx] for s in leaves]

        old = opt_state.step.pieces[idx]
        new_p, st = adam_update(at(g_leaves), AdamState(old, at(mu), at(nu)),
                                at(p_leaves), lr=lr_fn(old))
        for arrays, leaves in zip(out, (new_p, st.mu, st.nu)):
            for a, t in zip(arrays, leaves):
                a[idx] = t
        step[idx] = st.step
    sharded = [[pt.Sharded(a, s.spec, s.shape, mesh)
                for a, s in zip(arrays, p_leaves)] for arrays in out]
    return (*sharded, pt.Sharded(step, pt.P(), (), mesh))
