"""Bucketed admission: deterministic same-length packing (port of
``repro/launch/server/admission.py`` over the port's ``BatchEngine``).

``BucketedAdmission`` sits between request intake and the engine.  It
holds arrivals in FIFO order and, each time ``admit()`` runs, stacks
the longest same-prompt-length run at the queue head (capped at
``max_group``) into ONE ``BatchEngine.admit_packed`` call -- one
batched prefill for the group instead of one per request.

Grouping is a pure function of the ARRIVAL ORDER: a group is the
maximal run of equal-length requests at the head, never shaped by how
many slots happen to be free right now (when slots are short, the
whole group WAITS).  That is the determinism contract the serving
pipeline's parity bar rests on: the threaded pipeline and the
single-threaded reference loop see the same arrival order, therefore
form the same groups, therefore issue the same batch-width prefills --
and identical widths are what make the resulting cache rows (and so
every later decode bit) identical: cuBLAS on the card (like XLA on the
reference's CPU) rounds a product differently at different row counts,
so a packed row equals another batch-k prefill's row, not a batch-1
prefill's.

Only EXACT equal lengths stack -- packing never pads (padding would
change the flash-prefill reduction order and leave junk bytes in the
cache).  Buckets still earn their name through the trace layer:
``trace.bucket_lengths`` aligns workload lengths up to the W/page
alignment of §11, so arrivals land on a handful of exact lengths and
head runs are long in practice.

With chunked prefill enabled the engine already interleaves admission
with decode (§11), and ``admit_packed`` is unavailable by design; the
bucketizer then degrades to a FIFO forwarder into ``engine.submit``.
"""
from __future__ import annotations

from collections import deque
from itertools import islice
from typing import Optional

import numpy as np

from repro_torch.launch.batch_engine import BatchEngine, Request

__all__ = ["BucketedAdmission"]


def _plen(req: Request) -> int:
    return int(np.asarray(req.prompt).shape[-1])


class BucketedAdmission:
    """FIFO bucketizer over one engine.  Not thread-safe by itself:
    callers serialize ``offer``/``admit`` (the pipeline runs both on
    its admission thread; the sync loop runs everything on one
    thread)."""

    def __init__(self, engine: BatchEngine,
                 max_group: Optional[int] = None):
        if max_group is not None and max_group < 1:
            raise ValueError(f"max_group must be >= 1, got {max_group}")
        self.engine = engine
        self.max_group = min(max_group or engine.capacity, engine.capacity)
        # chunked admission has its own stall-free path (§11); packed
        # monolithic prefill would reintroduce the stall it removes
        self.packed = engine.prefill_chunk is None
        self._pending: deque[Request] = deque()
        self.n_groups = 0
        self.n_packed = 0

    # ---------------------------------------------------------------- intake
    def offer(self, req: Request) -> None:
        """Append one arrival (FIFO; grouping happens at admit time)."""
        self._pending.append(req)

    @property
    def depth(self) -> int:
        """Arrivals not yet handed to the engine."""
        return len(self._pending)

    def cancel_pending(self) -> list[Request]:
        """Drop and return every not-yet-admitted arrival (shutdown)."""
        dropped = list(self._pending)
        self._pending.clear()
        return dropped

    # ------------------------------------------------------------- admission
    def head_group_len(self) -> int:
        """Size of the group ``admit()`` would form right now (0 when
        nothing is pending).  The pipeline's admission hold-off peeks
        at this to decide whether a partial group is worth waiting on."""
        if not self._pending:
            return 0
        head_len = _plen(self._pending[0])
        n = 1
        for req in islice(self._pending, 1, self.max_group):
            if _plen(req) != head_len:
                break
            n += 1
        return n

    def admit(self) -> int:
        """Move head groups into the engine while slots allow; returns
        how many requests were handed over.  Takes the engine lock once
        for the whole sweep, so a concurrent decode quantum never
        observes a half-admitted group."""
        eng = self.engine
        moved = 0
        with eng.lock:
            if not self.packed:
                while self._pending:
                    eng.submit(self._pending.popleft())
                    moved += 1
                return moved
            while self._pending:
                k = self.head_group_len()
                if k > eng.n_free_slots:
                    break  # the group waits whole; groups never reshape
                group = [self._pending.popleft() for _ in range(k)]
                eng.trace.instant("admit.group", cat="sched", rows=k,
                                  tokens=_plen(group[0]))
                eng.admit_packed(group)
                self.n_groups += 1
                self.n_packed += k
                moved += k
        return moved
