"""Host-RAM (optionally disk-backed) LRU store of evicted prefix pages
(port of ``repro/launch/prefix_store.py:74-269``, its disk-tier trace
instants included).

The paged pool's prefix index only matches prompts whose pages are still
resident.  This is the tier behind it: when the last row that maps a
registered prompt page retires or is preempted, the engine exports the
page's bytes (``policy.export_pages``: int4 codes and scales, int8 codes
and scales, or bf16 K/V, exactly as resident) and parks them here; a
later admission restores them with ``policy.import_pages``, a copy and
not a recompute.

Keys are the page-aligned prompt-prefix bytes the device index uses
(``prompt[:(i + 1) * page_size].tobytes()``), one entry per page, so a
prefix of N pages restores as N key hits walked from the start.  Page
content is a function of the tokens, so a re-put of a present key only
refreshes its recency.

Capacity is a byte budget over the RAM tier.  On overflow the least
recently used entry goes to ``spill_dir`` when one is given (a third
tier, whose hits are promoted back to RAM), else it is dropped.  Pages
are put in page order, so a prefix that overflows the budget loses its
first page first, and then nothing of it restores: the reference's
behaviour, kept.  A spill file holds each leaf's raw bytes beside its
torch dtype name and shape (an ``.npz`` of ``uint8`` views); the names
map back through this module's own table, so bf16 needs nothing beyond
torch and numpy.  The files are the port's own format.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

__all__ = ["PrefixStore"]

_DTYPES = {str(t).removeprefix("torch."): t for t in (
    torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.uint8,
    torch.int8, torch.int16, torch.int32, torch.int64, torch.bool)}


def _payload_nbytes(payload: tuple) -> int:
    return int(sum(t.numel() * t.element_size() for t in payload))


class _RamEntry:
    __slots__ = ("payload", "nbytes")

    def __init__(self, payload: tuple):
        self.payload = payload
        self.nbytes = _payload_nbytes(payload)


class _DiskEntry:
    __slots__ = ("path", "nbytes")

    def __init__(self, path: str, nbytes: int):
        self.path = path
        self.nbytes = nbytes


class PrefixStore:
    """Byte-bounded LRU over exported page payloads.  A payload is one
    page's tuple of CPU tensors (one per pool leaf, the layer axis
    leading).  Thread-safe: every public method takes the store's lock."""

    def __init__(self, capacity_bytes: int,
                 spill_dir: Optional[str] = None):
        if capacity_bytes < 0:
            raise ValueError(
                f"capacity_bytes must be >= 0, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self.spill_dir = spill_dir
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, _RamEntry | _DiskEntry]" \
            = OrderedDict()
        self.ram_bytes = 0
        self.disk_bytes = 0
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0  # dropped outright (no disk tier)
        self.disk_spills = 0
        self.disk_loads = 0
        # the engine's TraceRecorder (ref ``prefix_store.py:108``): the
        # engine assigns its own, which records the disk tier's traffic
        self.trace = None

    # ------------------------------------------------------------- disk tier
    def _disk_path(self, key: bytes) -> str:
        return os.path.join(self.spill_dir,
                            hashlib.sha1(key).hexdigest() + ".npz")

    def _disk_write(self, key: bytes, payload: tuple) -> _DiskEntry:
        arrs, meta = {}, []
        for i, t in enumerate(payload):
            t = t.contiguous()
            arrs[f"leaf{i}"] = t.reshape(-1).view(torch.uint8).numpy()
            meta.append({"dtype": str(t.dtype).removeprefix("torch."),
                         "shape": list(t.shape)})
        arrs["meta"] = np.frombuffer(json.dumps(meta).encode(),
                                     np.uint8).copy()
        path = self._disk_path(key)
        buf = io.BytesIO()
        np.savez(buf, **arrs)
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        return _DiskEntry(path, _payload_nbytes(payload))

    def _disk_read(self, ent: _DiskEntry) -> Optional[tuple]:
        try:
            with np.load(ent.path) as z:
                meta = json.loads(bytes(z["meta"]).decode())
                return tuple(
                    torch.from_numpy(np.array(z[f"leaf{i}"])).view(
                        _DTYPES[m["dtype"]]).reshape(m["shape"])
                    for i, m in enumerate(meta))
        except (OSError, KeyError, ValueError, RuntimeError):
            return None  # a vanished or corrupt spill file is a miss

    @staticmethod
    def _disk_drop(ent: _DiskEntry) -> None:
        try:
            os.remove(ent.path)
        except OSError:
            pass

    # -------------------------------------------------------------- RAM tier
    def _evict_to_cap(self) -> None:
        """Push the LRU tail out of RAM until the budget holds.  Disk
        entries do not count against it and keep their LRU position."""
        while self.ram_bytes > self.capacity_bytes:
            victim = next((k for k, e in self._entries.items()
                           if isinstance(e, _RamEntry)), None)
            if victim is None:
                break
            ent = self._entries.pop(victim)
            self.ram_bytes -= ent.nbytes
            if self.spill_dir is not None:
                dent = self._disk_write(victim, ent.payload)
                self._entries[victim] = dent
                self._entries.move_to_end(victim, last=False)
                self.disk_bytes += dent.nbytes
                self.disk_spills += 1
                if self.trace is not None:
                    self.trace.instant("store.spill", cat="offload",
                                       tier="disk", bytes=dent.nbytes)
            else:
                self.evictions += 1

    # --------------------------------------------------------------- surface
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        with self._lock:
            return key in self._entries

    def touch(self, key: bytes) -> None:
        """Refresh recency without reading (a re-spill of a present key)."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)

    def put(self, key: bytes, payload: tuple) -> None:
        """Insert one page's exported bytes (CPU tensors, kept as given
        when contiguous).  A present key only refreshes its recency; a
        page over the whole budget skips RAM."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return
            ent = _RamEntry(tuple(t.contiguous() for t in payload))
            self.puts += 1
            if ent.nbytes > self.capacity_bytes:
                if self.spill_dir is not None:
                    dent = self._disk_write(key, ent.payload)
                    self._entries[key] = dent
                    self.disk_bytes += dent.nbytes
                    self.disk_spills += 1
                else:
                    self.evictions += 1
                return
            self._entries[key] = ent
            self.ram_bytes += ent.nbytes
            self._evict_to_cap()

    def get(self, key: bytes) -> Optional[tuple]:
        """Look one page up; a disk hit loads the entry and promotes it
        back into RAM (evicting colder RAM entries if needed)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            if isinstance(ent, _DiskEntry):
                payload = self._disk_read(ent)
                self._entries.pop(key)
                self.disk_bytes -= ent.nbytes
                self._disk_drop(ent)
                if payload is None:
                    self.misses += 1
                    return None
                self.disk_loads += 1
                if self.trace is not None:
                    self.trace.instant("store.load", cat="offload",
                                       tier="disk", bytes=ent.nbytes)
                rent = _RamEntry(payload)
                if rent.nbytes <= self.capacity_bytes:
                    self._entries[key] = rent
                    self.ram_bytes += rent.nbytes
                    self._evict_to_cap()
                self.hits += 1
                return payload
            self._entries.move_to_end(key)
            self.hits += 1
            return ent.payload

    @property
    def nbytes(self) -> int:
        return self.ram_bytes + self.disk_bytes

    def stats(self) -> dict:
        with self._lock:
            n_disk = sum(1 for e in self._entries.values()
                         if isinstance(e, _DiskEntry))
            return {
                "capacity_bytes": self.capacity_bytes,
                "ram_bytes": self.ram_bytes,
                "disk_bytes": self.disk_bytes,
                "pages_ram": len(self._entries) - n_disk,
                "pages_disk": n_disk,
                "hits": self.hits,
                "misses": self.misses,
                "puts": self.puts,
                "evictions": self.evictions,
                "disk_spills": self.disk_spills,
                "disk_loads": self.disk_loads,
            }
