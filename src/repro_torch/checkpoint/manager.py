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

``restore(..., device_fn=)`` is the single-device counterpart of the
reference's ``sharding_fn``: it places each leaf where the caller says.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Any, Callable, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager"]

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


def _to_storable(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
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


def _leaves(tree: Any) -> list:
    """The leaves in JAX's order: a dict by sorted key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _fill(example: Any, it) -> Any:
    """``example``'s structure (its dict order kept) with its leaves taken
    from ``it`` in ``_leaves`` order."""
    if isinstance(example, dict):
        vals = {k: _fill(example[k], it) for k in sorted(example)}
        return {k: vals[k] for k in example}
    if isinstance(example, (list, tuple)):
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

        leaves = _leaves(tree)
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                             allowZip64=True) as zf:
            for i, leaf in enumerate(leaves):
                with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, _to_storable(leaf),
                                              allow_pickle=False)
        meta = {
            "step": step,
            "n_leaves": len(leaves),
            "treedef": _treedef(tree),
            "dtypes": [_dtype_name(t) for t in leaves],
            "shapes": [list(t.shape) for t in leaves],
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
                device_fn: Optional[Callable] = None):
        """Restore into the structure of ``example_tree``: (tree, metadata).

        Each leaf takes the example leaf's dtype and its device, or the
        device ``device_fn(leaf_index, example_leaf)`` returns (None: the
        example's)."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        ex_leaves = _leaves(example_tree)
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
                dev = device_fn(i, ex) if device_fn is not None else None
                out.append(saved.to(device=ex.device if dev is None else dev,
                                    dtype=ex.dtype))
        return _fill(example_tree, iter(out)), meta["metadata"]

    # ------------------------------------------------------------------- gc
    def _gc(self):
        for s in _step_dirs(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))
