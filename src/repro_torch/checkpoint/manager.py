"""Checkpoint manager: atomic step checkpoints, keep-k GC, exact resume
(port of ``repro/checkpoint/manager.py``).

Format (the reference's, so either package reads the other's files): one
directory per step, ``<dir>/step_%08d/``, containing
  * arrays.npz  -- the flattened tree's leaves as ``leaf_i`` (host numpy)
  * meta.json   -- step, n_leaves, treedef, leaf dtypes/shapes and user
                   metadata (data-iterator state, ...)
Writes go to ``step_XXX.tmp`` then ``os.rename``: atomic visibility, so a
crash mid-write never corrupts the latest checkpoint.

Trees are the port's containers (dicts, lists, tuples, NamedTuples such
as ``AdamState``) of tensors.  Leaves are numbered in JAX's flattening
order (a dict's keys sorted), so a tree the reference saved reads back
into the same tree here; a restored tree keeps the example's key order.
npz has no bfloat16 or fp8: such a leaf is stored as a same-width integer
view and its dtype recorded by name, then viewed back through this
module's own table of torch dtypes (no ``ml_dtypes``).  The archive is
written one leaf at a time, so the host holds one leaf, not the whole
tree (a full-width internlm2-1.8b ``(params, opt)`` is ~18.9 GB).

Elastic re-mesh (the reference's ``sharding_fn``): a leaf is saved whole,
so a ``partitioning.Sharded`` leaf is gathered first and its bytes on
disk are the unsharded tree's; ``restore(..., sharding_fn=)`` then places
each leaf on the mesh (and by the spec) the caller gives, which need not
be the one it was saved from (``launch/sharded_train.py``).
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.launch.partitioning import (
    PartitionSpec,
    Sharded,
    gather_tree,
    place,
)

__all__ = ["CheckpointManager", "leaves"]

# dtype name (as meta.json records it) -> torch dtype, and the integer
# view npz stores for the names numpy cannot hold
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_VIEWS = {"bfloat16": (torch.int16, np.uint16),
          "float8_e4m3fn": (torch.uint8, np.uint8),
          "float8_e5m2": (torch.uint8, np.uint8)}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_storable(t) -> np.ndarray:
    t = gather_tree(t, "cpu") if isinstance(t, Sharded) else t.detach().cpu()
    t = t.contiguous()
    view = _VIEWS.get(_dtype_name(t))
    if view is None:
        return t.numpy()
    return t.view(view[0]).numpy().view(view[1])


def _from_storable(a: np.ndarray, name: str) -> torch.Tensor:
    if not a.flags.writeable:  # a tensor must own memory it may write
        a = a.copy()
    if name in _VIEWS:
        t = torch.from_numpy(a.view(_VIEWS[name][1]))
        return t.view(_VIEWS[name][0]).view(_DTYPES[name])
    return torch.from_numpy(a)


def _is_container(tree: Any) -> bool:
    return isinstance(tree, (list, tuple)) and not isinstance(
        tree, PartitionSpec)


def leaves(tree: Any) -> list:
    """The leaves in a checkpoint's order, JAX's: a dict by sorted key.  A
    tensor, a ``Sharded`` and a ``PartitionSpec`` are leaves, so a spec
    tree lines up with the state it places (``sharding_fn``'s index)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if _is_container(tree):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _fill(example: Any, it) -> Any:
    """``example``'s structure (its dict order kept) with its leaves taken
    from ``it`` in ``leaves`` order."""
    if isinstance(example, dict):
        vals = {k: _fill(example[k], it) for k in sorted(example)}
        return {k: vals[k] for k in example}
    if _is_container(example):
        children = [_fill(v, it) for v in example]
        if hasattr(example, "_fields"):
            return type(example)(*children)
        return type(example)(children)
    return next(it)


def _treedef(tree: Any) -> str:
    """The tree's structure as text, a leaf as ``*``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(map(_treedef, tree)) + "]"
    if isinstance(tree, tuple):
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return name + "(" + ", ".join(map(_treedef, tree)) + ")"
    return "*"


def _step_dirs(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, *, metadata: Optional[dict] = None
             ) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        flat = leaves(tree)
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                             allowZip64=True) as zf:
            for i, leaf in enumerate(flat):
                with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, _to_storable(leaf),
                                              allow_pickle=False)
        meta = {
            "step": step,
            "n_leaves": len(flat),
            "treedef": _treedef(tree),
            "dtypes": [_dtype_name(t) for t in flat],
            "shapes": [list(t.shape) for t in flat],
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic visibility
        self._gc()
        return final

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = _step_dirs(self.directory)
        return steps[-1] if steps else None

    def restore(self, step: int, example_tree, *,
                sharding_fn: Optional[Callable] = None):
        """Restore into the structure of ``example_tree``: (tree, metadata).

        Each leaf takes the example leaf's dtype and its placement: its
        device, or for a ``Sharded`` example its mesh and spec.
        ``sharding_fn(leaf_index, example_leaf)`` overrides that per leaf:
        a ``(mesh, spec)`` pair places the leaf on that mesh by that spec
        (``partitioning.shard_tree``'s placement: the elastic re-mesh), a
        ``torch.device`` puts it whole there, and None keeps the
        example's placement."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        ex_leaves = leaves(example_tree)
        if meta["n_leaves"] != len(ex_leaves):
            raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, "
                             f"example {len(ex_leaves)}")
        out = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for i, ex in enumerate(ex_leaves):
                saved = _from_storable(data[f"leaf_{i}"], meta["dtypes"][i])
                if tuple(saved.shape) != tuple(ex.shape):
                    raise ValueError(f"leaf {i}: checkpoint shape "
                                     f"{tuple(saved.shape)}, example "
                                     f"{tuple(ex.shape)}")
                where = sharding_fn(i, ex) if sharding_fn is not None \
                    else None
                if where is None:
                    where = (ex.mesh, ex.spec) if isinstance(ex, Sharded) \
                        else ex.device
                saved = saved.to(dtype=ex.dtype)
                if isinstance(where, tuple):
                    mesh, spec = where
                    out.append(place(saved, spec, mesh))
                else:
                    out.append(saved.to(device=where))
        return _fill(example_tree, iter(out)), meta["metadata"]

    # ------------------------------------------------------------------- gc
    def _gc(self):
        for s in _step_dirs(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))
