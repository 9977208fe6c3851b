"""Sharding rules: map every leaf of a tree to a ``PartitionSpec`` over a
mesh (port of ``repro/launch/partitioning.py``), and place a tree on the
mesh by those specs.

The rules are the reference's, rung for rung (DESIGN.md §4, §16):

  * params: 'model' on the largest divisible non-stacked dim, then
    'data' on the next; layer-stack dims are never sharded
    (``layout="sp_fsdp"`` switches to ``act_sharding``'s FSDP layout);
  * batch: dim 0 over ('pod', 'data');
  * KV caches and recurrent state (``cache_specs``): batch over the data
    axes when divisible, KV heads over 'model' when divisible, else the
    sequence axis; batch 1 spreads the sequence over the data axes too;
  * serving (``serve_cache_specs``): KV heads over 'model' when divisible,
    split-K over the sequence only when asked, else replication; paging
    metadata, lengths and rotations always replicated.

Everything degrades to replication when divisibility fails, and
replication is always spelled ``P()``.

A rule reads a tree whose leaves have ``.shape`` (tensors, or
``ShapeLeaf``) and the names along each leaf's path: dict keys, dataclass
and named-tuple fields, ``"data"`` for a ``CacheState``'s state, and
``""`` for a list or tuple index, as jax's key paths name them (a path
keeps the index itself, an int, so that a tuple's leaves stay apart).
``param_specs`` and ``cache_specs`` expect the reference's layer-stacked
layout, where a stacked subtree's leaves lead with their layer axes; the
port keeps per-layer lists, and ``stacked_view`` gives their stacked
shapes (a list of like subtrees becomes one subtree of ``ShapeLeaf``s).
``serve_cache_specs`` indexes from the end, so it reads a per-layer state
as it is; ``layer_param_specs`` reads ``param_specs`` back onto the
port's per-layer params (the sharded train step's layout,
``launch/sharded_train.py``).

Placement is single-controller (``launch/mesh.py``): ``shard_tree`` splits
each leaf along its assigned dims and puts one piece on every mesh
device (replicated leaves whole), ``gather_tree`` is its inverse, the
counterpart of ``np.asarray`` on a sharded leaf.  Serving does not place
whole trees: ``launch/sharded_cache.py`` splits each attention state by
KV head into one state per 'model' index.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.launch.mesh import data_axes

__all__ = [
    "PartitionSpec",
    "P",
    "ShapeLeaf",
    "Sharded",
    "auto_spec",
    "param_specs",
    "layer_param_specs",
    "batch_specs",
    "cache_specs",
    "serve_cache_specs",
    "STACKED_PREFIXES",
    "tree_map_with_path",
    "flatten_with_path",
    "stacked_view",
    "place",
    "shard_tree",
    "gather_tree",
    "replicate_tree",
    "path_names",
]


class PartitionSpec(tuple):
    """One mesh axis name (or a tuple of them, or None) per leaf dim;
    ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


P = PartitionSpec


class ShapeLeaf(NamedTuple):
    """A leaf that only has a shape (and a dtype): the port's counterpart
    of ``jax.ShapeDtypeStruct``."""

    shape: tuple
    dtype: Any = None


# cache fields that carry K/V content.  Layouts all place the KV head
# axis third from last:
#   dense seq-major   ([L,] B, Hkv, S, c)     -- head -3, seq -2
#   residual rings    ([L,] B, Hkv, W, d)     -- head -3 (W is a ring)
#   paged pools       ([L,] NP, Hkv, ps, c)   -- head -3 (ps is in-page)
_SEQ_MAJOR_FIELDS = frozenset(
    ("k_packed", "k_scales", "v_packed", "v_scales", "k", "v",
     "k_codes", "v_codes")
)
_RESIDUAL_FIELDS = frozenset(("k_residual", "v_residual"))
# paging / scheduler metadata: every shard needs the same copy
_REPLICATED_FIELDS = frozenset(("page_table", "refcount", "length", "pos"))

# param-tree keys whose leaves carry leading layer-stack axes (in the
# port: the depth of nested per-layer lists under the key)
STACKED_PREFIXES = {
    "blocks": 1,
    "mamba_rem": 1,
    "slstm": 1,
    "enc_layers": 1,
    "dec_layers": 1,
    "mamba_super": 2,
    "mlstm_super": 2,
}


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, ShapeLeaf))


def _children(obj):
    """(name, child) pairs of a container, None for a leaf or a scalar."""
    from repro_torch.core.cache_api import CacheState

    if isinstance(obj, dict):
        return [(str(k), v) for k, v in obj.items()]
    if isinstance(obj, CacheState):
        return [("data", obj.data)]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return [(f, getattr(obj, f)) for f in obj._fields]
    if isinstance(obj, (list, tuple)):
        return list(enumerate(obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [(f.name, getattr(obj, f.name))
                for f in dataclasses.fields(obj)]
    return None


def _rebuild(obj, values: list):
    """``obj``'s container with its children replaced by ``values``."""
    from repro_torch.core.cache_api import CacheState

    if isinstance(obj, dict):
        return dict(zip(obj.keys(), values))
    if isinstance(obj, CacheState):
        return CacheState(obj.policy, values[0])
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*values)
    if isinstance(obj, (list, tuple)):
        return type(obj)(values)
    return dataclasses.replace(obj, **{
        f.name: v for f, v in zip(dataclasses.fields(obj), values)})


def path_names(path: tuple) -> list:
    """A path's names, as the reference's rules read them: a sequence
    index has none."""
    return ["" if isinstance(p, int) else p for p in path]


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` on every leaf (a tensor or ``ShapeLeaf``), the
    containers rebuilt around the results; ``path`` holds the field
    names and sequence indices.  Anything else (a Python int length, a
    string) is kept as it is."""
    if _is_leaf(tree):
        return fn(path, tree)
    kids = _children(tree)
    if kids is None:
        return tree
    return _rebuild(tree, [tree_map_with_path(fn, v, path + (k,))
                           for k, v in kids])


def flatten_with_path(tree, path: tuple = ()) -> list:
    """(path, leaf) pairs in tree order; a spec, a tensor and a
    ``ShapeLeaf`` are leaves, and so is ``Sharded``."""
    if isinstance(tree, (PartitionSpec, Sharded)) or _is_leaf(tree):
        return [(path, tree)]
    kids = _children(tree)
    if kids is None:
        return []
    return [pl for k, v in kids for pl in flatten_with_path(v, path + (k,))]


def _stack(items: list):
    """Like subtrees -> one subtree whose leaves lead with len(items)."""
    first = items[0]
    if _is_leaf(first):
        return ShapeLeaf((len(items), *first.shape),
                         getattr(first, "dtype", None))
    kids = _children(first)
    if kids is None:
        return None
    per = [_children(it) for it in items]
    return _rebuild(first, [_stack([p[i][1] for p in per])
                            for i in range(len(kids))])


def stacked_view(tree):
    """The reference's layer-stacked layout of a port tree, as shapes: a
    list of like subtrees (per-layer params or cache states) becomes one
    subtree whose leaves lead with the list's length; nested lists stack
    to depth 2.  Tuples (a paged state's ``pools``) are kept."""
    if _is_leaf(tree):
        return ShapeLeaf(tuple(tree.shape), getattr(tree, "dtype", None))
    if isinstance(tree, list) and tree:
        return _stack([stacked_view(t) for t in tree])
    kids = _children(tree)
    if kids is None:
        return None
    return _rebuild(tree, [stacked_view(v) for _, v in kids])


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name]


def auto_spec(shape, mesh, *, skip_dims: int = 0, batch_dim=None):
    """Generic assignment: 'model' -> largest divisible dim, then 'data'.
    ``skip_dims`` leading stack dims stay unsharded; ``batch_dim`` gets the
    composed data axes (('pod', 'data')) instead."""
    n = len(shape)
    assign: list = [None] * n
    used = set(range(skip_dims))
    used_axes: set = set()
    if batch_dim is not None:
        daxes = data_axes(mesh)
        dsize = int(np.prod([_axis_size(mesh, a) for a in daxes]))
        if shape[batch_dim] % dsize == 0 and shape[batch_dim] > 0:
            assign[batch_dim] = daxes if len(daxes) > 1 else daxes[0]
            used_axes.update(daxes)
        used.add(batch_dim)
    for ax in ("model", "data"):
        if ax not in mesh.axis_names or ax in used_axes:
            continue
        size = _axis_size(mesh, ax)
        cands = [i for i in range(n)
                 if i not in used and shape[i] % size == 0
                 and shape[i] >= size]
        if cands:
            i = max(cands, key=lambda i: shape[i])
            assign[i] = ax
            used.add(i)
    return P(*assign)


def param_specs(params_shapes, mesh, *, layout: str = "baseline"):
    """Spec tree matching a (layer-stacked) params tree.
    ``layout="sp_fsdp"`` switches to ``fsdp_param_specs`` (the reference
    reads it from ``REPRO_SHARDING``; here the caller passes it)."""
    if layout == "sp_fsdp":
        from repro_torch.launch.act_sharding import fsdp_param_specs

        return fsdp_param_specs(params_shapes, mesh)

    def spec_for(path, leaf):
        skip = STACKED_PREFIXES.get(path_names(path)[0], 0)
        return auto_spec(leaf.shape, mesh, skip_dims=skip)

    return tree_map_with_path(spec_for, params_shapes)


def layer_param_specs(params, mesh, *, layout: str = "baseline"):
    """Spec tree shaped like the port's per-layer params tree: each leaf
    takes the spec that ``param_specs(stacked_view(params), mesh,
    layout=)`` gives its stacked leaf, without the leading layer axes (one
    a level of per-layer lists; those axes are never sharded,
    ``STACKED_PREFIXES``)."""
    stacked = dict(flatten_with_path(
        param_specs(stacked_view(params), mesh, layout=layout)))

    def walk(tree, spath: tuple, depth: int):
        if isinstance(tree, list):
            return [walk(v, spath, depth + 1) for v in tree]
        if _is_leaf(tree):
            spec = stacked[spath]
            if any(a is not None for a in spec[:depth]):
                raise ValueError(f"{spath}: {spec} shards a layer axis")
            return P(*spec[depth:])
        kids = _children(tree)
        if kids is None:
            return tree
        return _rebuild(tree, [walk(v, spath + (k,), depth)
                               for k, v in kids])

    return walk(params, (), 0)


def batch_specs(batch_shapes, mesh):
    """Batch dict: dim 0 is always the (global) batch dimension."""

    def spec_for(path, leaf):
        if not leaf.shape:
            return P()
        return auto_spec(leaf.shape, mesh, batch_dim=0)

    return tree_map_with_path(spec_for, batch_shapes)


def cache_specs(cache_shapes, mesh):
    """KV caches and recurrent state, layer-stacked (leading L, never
    sharded; two stack axes under ``ssm_super`` and ``mlstm``).  Batch ->
    data axes if divisible; then Hkv -> 'model' if divisible, else S ->
    'model'; batch 1 -> S gets the data axes too."""
    daxes = data_axes(mesh)
    dsize = int(np.prod([_axis_size(mesh, a) for a in daxes]))
    msize = _axis_size(mesh, "model")

    def spec_for(path, leaf):
        names = path_names(path)
        shape = leaf.shape
        field = names[-1] if names else ""
        if not shape:
            return P()
        # the rotations inside an int4 state: small per-layer constants
        if "rot_k" in names or "rot_v" in names:
            return P()
        if any(n in _REPLICATED_FIELDS for n in names if n):
            return P()
        # paged pools and residual rings: the KV head axis (-3) when
        # divisible, never the page, in-page, window or channel axes
        if any(n == "pools" or n == "residual" for n in names):
            assign = [None] * len(shape)
            if len(shape) >= 3 and shape[-3] % msize == 0:
                assign[len(shape) - 3] = "model"
            return P(*assign)
        top = names[0] if names else ""
        skip = 2 if top in ("ssm_super", "mlstm") else 1
        if top == "pos" or len(shape) <= skip:
            return P()
        assign: list = [None] * len(shape)
        b_dim = skip
        seq_dim = None
        head_dim_idx = None
        if field in _SEQ_MAJOR_FIELDS:
            head_dim_idx = skip + 1 if len(shape) > skip + 1 else None
            seq_dim = skip + 2 if len(shape) > skip + 2 else None
        elif field in _RESIDUAL_FIELDS:
            head_dim_idx = skip + 1 if len(shape) > skip + 1 else None
        if shape[b_dim] % dsize == 0:
            assign[b_dim] = daxes if len(daxes) > 1 else daxes[0]
        model_placed = False
        if head_dim_idx is not None and shape[head_dim_idx] % msize == 0:
            assign[head_dim_idx] = "model"
            model_placed = True
        if not model_placed and seq_dim is not None \
                and shape[seq_dim] % msize == 0:
            assign[seq_dim] = "model"
            model_placed = True
        if assign[b_dim] is None and seq_dim is not None:
            # batch 1, long context: the sequence over the data axes
            if shape[seq_dim] % (dsize * (msize if not model_placed
                                          else 1)) == 0:
                if assign[seq_dim] != "model" and model_placed:
                    assign[seq_dim] = daxes if len(daxes) > 1 else daxes[0]
        if not model_placed:
            # recurrent states etc.: the largest remaining divisible dim
            cands = [i for i in range(skip, len(shape))
                     if assign[i] is None and shape[i] % msize == 0]
            if cands:
                assign[max(cands, key=lambda i: shape[i])] = "model"
        return P(*assign)

    return tree_map_with_path(spec_for, cache_shapes)


def serve_cache_specs(cache_shapes, mesh, *, allow_split_k: bool = False):
    """Serving cache specs (DESIGN.md §16), bit-exact by construction.
    Scheduler state is replicated (any slot may move), so the ladder never
    touches the batch axis:

      1. KV head axis -> 'model' when divisible: attention is parallel
         over KV heads, so streams and cache bytes equal one device's;
      2. ``allow_split_k=True`` only: the sequence axis of dense
         seq-major leaves takes 'model' (split-K; the softmax combine
         re-associates, so not bit-exact);
      3. replication.

    Residual rings shard their heads only; page tables, refcounts,
    lengths and rotations are never sharded."""
    msize = _axis_size(mesh, "model") if "model" in mesh.axis_names else 1

    def spec_for(path, leaf):
        names = path_names(path)
        shape = leaf.shape
        field = names[-1] if names else ""
        if not shape or len(shape) < 3 or msize <= 1:
            return P()
        if "rot_k" in names or "rot_v" in names:
            return P()
        if any(n in _REPLICATED_FIELDS for n in names if n):
            return P()
        kv_bearing = (field in _SEQ_MAJOR_FIELDS or field in _RESIDUAL_FIELDS
                      or any(n == "pools" or n == "residual" for n in names))
        if not kv_bearing:
            return P()
        assign: list = [None] * len(shape)
        if shape[-3] % msize == 0:
            assign[len(shape) - 3] = "model"  # KV heads: exact
        elif allow_split_k and field in _SEQ_MAJOR_FIELDS \
                and shape[-2] % msize == 0:
            assign[len(shape) - 2] = "model"  # split-K: not bit-exact
        if not any(a is not None for a in assign):
            return P()
        return P(*assign)

    return tree_map_with_path(spec_for, cache_shapes)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _dim_splits(spec, mesh) -> list:
    """Per sharded dim: (dim, axes, n pieces)."""
    out = []
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        out.append((dim, axes, int(np.prod([mesh.shape[a] for a in axes]))))
    return out


def _piece_index(coord: dict, axes: tuple, mesh) -> int:
    """Row-major index of a device coordinate over ``axes``."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coord[a]
    return i


@dataclasses.dataclass
class Sharded:
    """A leaf placed on a mesh: ``pieces[coord]`` is the tensor the device
    at mesh coordinate ``coord`` holds (its slice, or a whole copy)."""

    pieces: np.ndarray  # object array shaped like mesh.devices
    spec: PartitionSpec
    shape: tuple
    mesh: Any

    @property
    def dtype(self):
        return self.pieces.flat[0].dtype


def place(x: torch.Tensor, spec, mesh) -> Sharded:
    """``x`` placed on ``mesh`` by ``spec``: one piece a mesh device."""
    splits = _dim_splits(spec, mesh)
    for dim, axes, n in splits:
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {axes} ({n})")
    pieces = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(mesh.devices.shape):
        coord = dict(zip(mesh.axis_names, idx))
        t = x
        for dim, axes, n in splits:
            size = x.shape[dim] // n
            t = t.narrow(dim, _piece_index(coord, axes, mesh) * size, size)
        pieces[idx] = t.to(mesh.devices[idx], copy=True).contiguous()
    return Sharded(pieces, P(*spec), tuple(x.shape), mesh)


def shard_tree(tree, specs, mesh):
    """Every tensor leaf of ``tree`` placed by its spec in ``specs`` (the
    same tree of ``PartitionSpec``s, as the rules return): one piece on
    each mesh device, split along the assigned dims and whole along the
    rest.  The port's ``device_put(tree, NamedSharding(mesh, spec))``."""
    spec_of = {p: s for p, s in flatten_with_path(specs)}

    return tree_map_with_path(
        lambda path, leaf: place(leaf, spec_of.get(path, P()), mesh), tree)


def _gather(s: Sharded, device=None) -> torch.Tensor:
    mesh = s.mesh
    dev = mesh.lead if device is None else torch.device(device)
    out = torch.empty(s.shape, dtype=s.dtype, device=dev)
    splits = _dim_splits(s.spec, mesh)
    used = {a for _, axes, _ in splits for a in axes}
    for idx in np.ndindex(mesh.devices.shape):
        coord = dict(zip(mesh.axis_names, idx))
        if any(coord[a] for a in mesh.axis_names if a not in used):
            continue  # a replica of a piece already copied
        view = out
        for dim, axes, n in splits:
            size = s.shape[dim] // n
            view = view.narrow(dim, _piece_index(coord, axes, mesh) * size,
                               size)
        view.copy_(s.pieces[idx])
    return out


def gather_tree(tree, device=None):
    """The inverse of :func:`shard_tree`: each ``Sharded`` leaf assembled
    whole on ``device`` (default: the mesh's lead device)."""
    if isinstance(tree, Sharded):
        return _gather(tree, device)
    kids = _children(tree)
    if kids is None:
        return tree
    return _rebuild(tree, [gather_tree(v, device) for _, v in kids])


def replicate_tree(tree, mesh):
    """Every tensor leaf on the mesh's lead device (the single controller
    runs replicated work once there: params, token buffers)."""
    if mesh is None:
        return tree
    lead = mesh.lead
    return tree_map_with_path(
        lambda _, t: t if not isinstance(t, torch.Tensor) else t.to(lead),
        tree)
