"""Activation-sharding policies (port of ``repro/launch/act_sharding.py``):
the rules of the sequence-parallel + FSDP layout and of bit-exact serving.

The reference hints activations at the model's boundaries with
``with_sharding_constraint`` and lets GSPMD partition the rest.  Two
policies give the hints:

  * ``sp_fsdp``: params FSDP over the flattened ('data', 'model') axes,
    activations batch over ('pod', 'data') and sequence over 'model',
    K/V replicated over 'model', experts over 'model';
  * ``serve_exact`` (DESIGN.md §16): projections, the merged attention
    output, the residual stream and the logits replicated, so only the
    attend against the head-sharded cache runs per shard.

The port is eager and single-controller: a tensor sits where it was
placed, and a sharding constraint changes no value, so ``hint`` returns
its argument.  The rules are kept (``spec_for``, ``fsdp_param_specs``) for
what places data by them.  Under a mesh the port realises ``serve_exact``
by construction rather than by hints: ``launch/sharded_cache.py``'s
policy proxy runs every projection once, at full width on the lead
device, splits only the cache writes and the attend by KV head, and
concatenates the heads back before ``wo``.  So the port's model files
carry no ``hint`` calls (the reference's are in ``models/attention.py``,
``lm.py``, ``flash.py`` and ``moe.py``).
"""
from __future__ import annotations

import contextlib
import contextvars

import numpy as np

from repro_torch.launch.partitioning import (
    STACKED_PREFIXES,
    P,
    path_names,
    tree_map_with_path,
)

__all__ = ["use_policy", "hint", "fsdp_param_specs"]

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_act_sharding", default=None)


class _Policy:
    """The sequence-parallel + FSDP activation layout."""

    def __init__(self, mesh, name: str = "sp_fsdp"):
        self.mesh = mesh
        self.name = name
        self.daxes = ("pod", "data") if "pod" in mesh.axis_names \
            else ("data",)
        self.dsize = int(np.prod([mesh.shape[a] for a in self.daxes]))
        self.msize = mesh.shape["model"] if "model" in mesh.axis_names else 1

    def spec_for(self, kind: str, shape):
        d = self.daxes if len(self.daxes) > 1 else self.daxes[0]
        if kind == "residual":  # (B, S, d)
            if len(shape) != 3:
                return None
            b = d if shape[0] % self.dsize == 0 else None
            s = "model" if shape[1] % self.msize == 0 and shape[1] > 1 \
                else None
            return P(b, s, None)
        if kind == "kv_full":  # (B, Hkv, S, hd): replicated over 'model'
            b = d if shape[0] % self.dsize == 0 else None
            return P(b, *([None] * (len(shape) - 1)))
        if kind == "logits":  # (B, S, V)
            b = d if shape[0] % self.dsize == 0 else None
            s = "model" if shape[1] % self.msize == 0 and shape[1] > 1 \
                else None
            return P(b, s, None)
        # expert parallelism: experts over 'model'
        if kind == "moe_gsec":  # (G, S, E, C) dispatch/combine masks
            g = d if shape[0] % self.dsize == 0 else None
            e = "model" if shape[2] % self.msize == 0 else None
            return P(g, None, e, None)
        if kind == "moe_gecd":  # (G, E, C, d) expert inputs/outputs
            g = d if shape[0] % self.dsize == 0 else None
            e = "model" if shape[1] % self.msize == 0 else None
            return P(g, e, None, None)
        return None


class _ServeExact:
    """Bit-exact tensor-parallel serving: the KV cache sharded by head,
    params and scheduler state replicated, projections and the merged
    attention output at full width (replicated)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.name = "serve_exact"

    def spec_for(self, kind: str, shape):
        if kind in ("qkv_proj", "attn_out", "kv_full", "residual",
                    "logits"):
            return P()
        return None


@contextlib.contextmanager
def use_policy(mesh, name: str = "sp_fsdp"):
    """Make ``name`` (baseline | serve_exact | sp_fsdp) the active policy
    for the block."""
    if name == "baseline":
        pol = None
    elif name == "serve_exact":
        pol = _ServeExact(mesh)
    else:
        pol = _Policy(mesh, name)
    tok = _ACTIVE.set(pol)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def hint(x, kind: str):
    """Returns ``x``: in eager single-controller PyTorch a constraint moves
    no value (see the module docstring)."""
    return x


def fsdp_param_specs(params_shapes, mesh):
    """FSDP: the largest divisible dim of every leaf over the flattened
    ('data', 'model') axes; layer-stack dims skipped (as ``auto_spec``);
    expert weights (E, d_in, d_out) put experts over 'model' and the
    largest remaining dim over 'data'."""
    axes = [a for a in ("data", "model") if a in mesh.axis_names]
    flat = tuple(axes)
    fsize = int(np.prod([mesh.shape[a] for a in axes]))
    msize = mesh.shape.get("model", 1)

    def spec_for(path, leaf):
        names = path_names(path)
        skip = STACKED_PREFIXES.get(names[0], 0)
        shape = leaf.shape
        assign = [None] * len(shape)
        if any("moe" in n for n in names) and len(shape) - skip == 3 \
                and shape[skip] % msize == 0:
            assign[skip] = "model"
            dsize = mesh.shape.get("data", 1)
            rest = [i for i in range(skip + 1, len(shape))
                    if shape[i] % dsize == 0]
            if rest:
                assign[max(rest, key=lambda i: shape[i])] = "data"
            return P(*assign)
        cands = [i for i in range(skip, len(shape))
                 if shape[i] % fsize == 0 and shape[i] >= fsize]
        if cands:
            assign[max(cands, key=lambda i: shape[i])] = flat
        else:
            # 'model'-only, then 'data'-only FSDP
            for ax in ("model", "data"):
                if ax not in mesh.axis_names:
                    continue
                size = mesh.shape[ax]
                c2 = [i for i in range(skip, len(shape))
                      if shape[i] % size == 0 and shape[i] >= size
                      and assign[i] is None]
                if c2:
                    assign[max(c2, key=lambda i: shape[i])] = ax
                    break
        return P(*assign)

    return tree_map_with_path(spec_for, params_shapes)
