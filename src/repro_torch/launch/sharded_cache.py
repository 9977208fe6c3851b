"""A KV cache sharded by head over a mesh's 'model' axis: the port's
counterpart of a ``CacheState`` that GSPMD partitioned by
``serve_cache_specs`` (ref ``repro/launch/engine.py:213-230``,
``batch_engine.py:508-528``, DESIGN.md §16).

``ShardedState`` holds one ``CacheState`` per 'model' index, on that
index's device (``Mesh.devices_along("model")``); shard j holds KV heads
``[j*Hkv/m, (j+1)*Hkv/m)`` of every K/V leaf (dense buffers, residual
rings, page pools).  What the specs replicate (lengths, page tables and
their host mirrors, refcounts, rotations) gets one copy per shard, and
every operation updates each copy by the same call, so the copies stay
equal.  Host-side metadata is read from shard 0 (``state.data``).

Its ``policy`` is a ``ShardedPolicy``: every policy operation runs shard
by shard.  It splits k/v by KV head and q by the query heads grouped
under those KV heads (G = Hq/Hkv, so the split is contiguous), moves
each piece to the shard's device, and concatenates the outputs in head
order on the lead device, ahead of the output projection.  The model
code is unchanged: projections run once at full width on the lead
device (the arithmetic the reference's ``serve_exact`` policy pins), and
only the cache writes and the attend run per shard, so streams and cache
bytes equal one device's by construction.

Where the specs give every KV leaf ``P()`` (MQA, a head count the axis
does not divide, a 'model' axis of 1) the cache stays one unsharded
state on the lead device: replication computes the same bytes.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import torch

from repro_torch.core import paged
from repro_torch.core.cache_api import CacheState
from repro_torch.core.transforms import Rotation
from repro_torch.launch import partitioning as pt

__all__ = ["ShardedState", "ShardedPolicy", "shard_state", "shard_cache",
           "gather_state", "step_lengths", "CACHE_KEYS"]

# the cache keys whose entries are lists of attention states
CACHE_KEYS = ("attn", "self", "cross")


def _split(x: torch.Tensor, m: int, j: int, dim: int = 1) -> torch.Tensor:
    n = x.shape[dim] // m
    return x.narrow(dim, j * n, n)


def _to(x, device):
    """A tensor moved to ``device`` (CPU host mirrors stay on the host);
    anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


class ShardedState:
    """One ``CacheState`` per 'model' index (``shards``), shard j on
    ``devices[j]``; ``specs`` are the serving specs of the unsharded
    state (which dim of each leaf is split).  Quacks like a
    ``CacheState`` for the model and the engines."""

    def __init__(self, shards: list, devices: list, lead: torch.device,
                 inner, specs):
        self.shards = shards
        self.devices = devices
        self.lead = lead
        self.specs = specs
        self.policy = ShardedPolicy(inner)

    @property
    def m(self) -> int:
        return len(self.shards)

    @property
    def data(self):
        """Shard 0's state: the host-side metadata (page table mirror,
        refcounts, lengths) every shard holds alike."""
        return self.shards[0].data

    @property
    def length(self):
        return self.shards[0].length

    @property
    def lengths(self):
        return self.shards[0].length

    @property
    def s_max(self) -> int:
        return self.shards[0].s_max

    @property
    def is_ragged(self) -> bool:
        return self.shards[0].is_ragged

    @property
    def is_paged(self) -> bool:
        return self.shards[0].is_paged

    def nbytes(self, *, persistent_only: bool = True,
               per_shard: bool = False) -> int:
        return self.policy.nbytes(self, persistent_only=persistent_only,
                                  per_shard=per_shard)

    def map_shards(self, fn) -> "ShardedState":
        """A new sharded state of ``fn(shard)`` for every shard."""
        return ShardedState([fn(s) for s in self.shards], self.devices,
                            self.lead, self.policy.inner, self.specs)


class ShardedPolicy:
    """The policy of a ``ShardedState`` (and of nothing else: a state the
    specs replicate keeps its own policy): each operation of the wrapped
    policy (``inner``) run once per shard.  Attributes the proxy does not
    define (``name``, ``window``, ``group``, ``supported_backends``,
    ``init_state``, ...) are ``inner``'s."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        if name == "inner":  # not set yet (a copy under construction)
            raise AttributeError(name)
        return getattr(self.inner, name)

    # -- helpers
    def _each(self, state, fn):
        """``fn(j, shard, device)`` for every shard, in order."""
        return [fn(j, s, d) for j, (s, d) in
                enumerate(zip(state.shards, state.devices))]

    @staticmethod
    def _heads(x, state, j, device):
        return _split(x, state.m, j).to(device).contiguous()

    def _gather_heads(self, outs: list, state) -> torch.Tensor:
        return torch.cat([o.to(state.lead) for o in outs], dim=1)

    # -- writes
    def _write(self, op, state, k, v, **kw) -> None:
        """``op(shard, k_j, v_j)`` for every shard.  Where the policy
        rotates (int4), each shard writes with ``_FullWidthRotation``s: the
        rows a write rotates into its fp32 ring are rotated once, at full
        width on the lead, by the call the unsplit write makes, and each
        shard takes its heads of them (a product's bits may depend on its
        row count, so a per-shard product could differ from the unsplit
        one).  The packed bulk goes through B3 per shard."""
        rots = None
        if hasattr(state.data, "rot_k"):
            rots = [_FullWidthRotation.over(state, side, src)
                    for side, src in (("rot_k", k), ("rot_v", v))]
        for j, (s, d) in enumerate(zip(state.shards, state.devices)):
            if rots is not None:
                s = CacheState(s.policy, dataclasses.replace(
                    s.data, rot_k=rots[0][j], rot_v=rots[1][j]))
            op(s, self._heads(k, state, j, d), self._heads(v, state, j, d),
               **{n: _to(t, d) for n, t in kw.items()})

    def prefill(self, state, k, v):
        self._write(self.inner.prefill, state, k, v)
        return state

    def update(self, state, k, v, *, active=None):
        self._write(self.inner.update, state, k, v, active=active)
        return state

    def prefill_chunk(self, state, k, v):
        self._write(self.inner.prefill_chunk, state, k, v)
        return state

    # -- reads
    def attend(self, q, state, **kw):
        """Per shard; where the policy rotates, the query's fold and the
        output's inverse rotation run once at full width on the lead, and
        each shard reads in rotated space (``_RotatedSpace``), through B1
        or B2 on a KERNEL read with the unsplit read's split-K plan
        (``plan_rows`` = B·Hkv), so every shard's rows equal the unsplit
        read's."""
        if not hasattr(state.data, "rot_k"):
            return self._gather_heads(self._each(
                state, lambda j, s, d: self.inner.attend(
                    self._heads(q, state, j, d), s, **kw)), state)
        rk, rv = (_rotation_to(getattr(state.data, side), state.lead)
                  for side in ("rot_k", "rot_v"))
        qf = q.float() @ rk.folded_query_matrix().T
        kw["plan_rows"] = q.shape[0] * state.m * _kv_heads(state.shards[0])
        out = self._gather_heads(self._each(
            state, lambda j, s, d: self.inner.attend(
                self._heads(qf, state, j, d), _RotatedSpace.over(s), **kw)),
            state)
        return rv.inverse(out).to(q.dtype)

    def verify_attend(self, q, state, snap, **kw):
        """As :meth:`attend`, one verify query at a time for the fold and
        the inverse, as the unsplit read does them."""
        if not hasattr(state.data, "rot_k"):
            return self._gather_heads(self._each(
                state, lambda j, s, d: self.inner.verify_attend(
                    self._heads(q, state, j, d), s, snap[j], **kw)), state)
        rk, rv = (_rotation_to(getattr(state.data, side), state.lead)
                  for side in ("rot_k", "rot_v"))
        fold = rk.folded_query_matrix().T
        kq = q.shape[2]
        qf = torch.cat([q[:, :, i:i + 1].float() @ fold for i in range(kq)],
                       dim=2)
        out = self._gather_heads(self._each(
            state, lambda j, s, d: self.inner.verify_attend(
                self._heads(qf, state, j, d), _RotatedSpace.over(s),
                snap[j], **kw)), state)
        return torch.cat([rv.inverse(out[:, :, i:i + 1].contiguous())
                          for i in range(kq)], dim=2).to(q.dtype)

    def raw_kv_view(self, state, n_tokens: Optional[int] = None):
        per = self._each(state, lambda j, s, d: self.inner.raw_kv_view(
            s, n_tokens))
        return tuple(self._gather_heads(list(leaves), state)
                     for leaves in zip(*per))

    # -- speculative rollback
    def snapshot_rows(self, state, into=None):
        return [self.inner.snapshot_rows(
                    s, into=None if into is None else into[j])
                for j, s in enumerate(state.shards)]

    def rollback_leaves(self, state) -> tuple:
        return tuple(itertools.chain.from_iterable(
            self.inner.rollback_leaves(s) for s in state.shards))

    def truncate_rows(self, state, new_length, snap):
        self._each(state, lambda j, s, d: self.inner.truncate_rows(
            s, _to(new_length, d), snap[j]))
        return state

    # -- admission and retirement
    def insert_row(self, state, row, slot):
        for s, r in zip(state.shards, row.shards):
            self.inner.insert_row(s, r, slot)
        return state

    def insert_row_paged(self, state, row, slot, shared_pages, n_shared,
                         n_new):
        for s, r in zip(state.shards, row.shards):
            self.inner.insert_row_paged(s, r, slot, shared_pages, n_shared,
                                        n_new)
        return state

    def adopt_prefix(self, row, paged_state, pages, n_tokens: int):
        for r, s in zip(row.shards, paged_state.shards):
            self.inner.adopt_prefix(r, s, pages, n_tokens)
        return row

    def reset_rows(self, state, mask):
        for s in state.shards:
            self.inner.reset_rows(s, mask)
        return state

    def with_rotations(self, state, rot_k, rot_v):
        return ShardedState(
            self._each(state, lambda j, s, d: self.inner.with_rotations(
                s, _rotation_to(rot_k, d), _rotation_to(rot_v, d))),
            state.devices, state.lead, self.inner, state.specs)

    # -- the host prefix tier
    def export_pages(self, state, pages) -> tuple:
        """The global page tiles: each leaf's shards concatenated by head
        (the bytes an unsharded pool exports), on the host."""
        per = [self.inner.export_pages(s, pages) for s in state.shards]
        return tuple(torch.cat(leaves, dim=1) for leaves in zip(*per))

    def import_pages(self, row, payload, n_tokens: int):
        self._each(row, lambda j, s, d: self.inner.import_pages(
            s, tuple(self._heads(t, row, j, d) for t in payload), n_tokens))
        return row

    # -- accounting
    def _meta(self, shard, persistent_only: bool) -> int:
        """Replicated bytes ``inner.nbytes`` counts: a paged state's page
        table and refcounts, outside ``persistent_only``."""
        if persistent_only or not shard.is_paged:
            return 0
        d = shard.data
        return paged.meta_nbytes(getattr(d, "kv", d))

    def nbytes(self, state, *, persistent_only: bool = True,
               per_shard: bool = False) -> int:
        """Global-logical by default (the unsharded figure: K/V leaves
        summed over shards, replicated metadata once); ``per_shard=True``
        is one shard's resident bytes (K/V / m, metadata in full)."""
        if per_shard:
            return self.inner.nbytes(state.shards[0],
                                     persistent_only=persistent_only)
        return sum(self.inner.nbytes(s, persistent_only=persistent_only)
                   - self._meta(s, persistent_only)
                   for s in state.shards) \
            + self._meta(state.shards[0], persistent_only)

    def bf16_equiv_bytes(self, state) -> int:
        return sum(self.inner.bf16_equiv_bytes(s) for s in state.shards)

    def compression_ratio(self, state, *, per_shard: bool = False) -> float:
        if per_shard:
            return self.inner.compression_ratio(state.shards[0])
        return self.bf16_equiv_bytes(state) / self.nbytes(state)


@dataclasses.dataclass
class _FullWidthRotation(Rotation):
    """Shard ``heads``' rotation for one write: its own matrix and lambda
    (what B3 reads for the packed bulk), but ``forward_at(x, index)``
    returns those heads of ``full.forward(source[index])``, the rows the
    unsplit write rotates, computed once for all shards (``memo``)."""

    full: Optional[Rotation] = None  # the rotation, on the lead device
    source: Optional[torch.Tensor] = None  # the full-width K or V
    heads: tuple = (0, 0)
    memo: Optional[dict] = None

    @classmethod
    def over(cls, state, side: str, source: torch.Tensor) -> list:
        """One per shard of ``state``, for its ``side`` (rot_k | rot_v)."""
        own = [getattr(s.data, side) for s in state.shards]
        full = _rotation_to(own[0], state.lead)
        n, memo = source.shape[1] // state.m, {}
        return [cls(r.matrix, r.lam, r.signs, r.kind, full=full,
                    source=source, heads=(j * n, (j + 1) * n), memo=memo)
                for j, r in enumerate(own)]

    def forward_at(self, x: torch.Tensor, index) -> torch.Tensor:
        key = repr(index)
        if key not in self.memo:
            self.memo[key] = self.full.forward(self.source[index])
        a, b = self.heads
        return self.memo[key][:, a:b].to(self.matrix.device)


@dataclasses.dataclass
class _RotatedSpace(Rotation):
    """A shard's rotations for one read whose query the lead has already
    folded: the fold is the identity (exact in fp32) and the inverse
    hands back the rotated-space output in fp32, which the lead gathers
    and inverse-rotates at full width."""

    @classmethod
    def over(cls, shard: CacheState) -> CacheState:
        d = shard.data
        return CacheState(shard.policy, dataclasses.replace(
            d, rot_k=cls(d.rot_k.matrix, d.rot_k.lam, d.rot_k.signs,
                         d.rot_k.kind),
            rot_v=cls(d.rot_v.matrix, d.rot_v.lam, d.rot_v.signs,
                      d.rot_v.kind)))

    def folded_query_matrix(self) -> torch.Tensor:
        return torch.eye(self.d, dtype=torch.float32,
                         device=self.matrix.device)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return y.float()


def _kv_heads(shard: CacheState) -> int:
    """The KV heads an int4 shard holds (dense buffers or page pools)."""
    kv = shard.data.kv
    return (kv.pools[0] if shard.is_paged else kv.k_packed).shape[1]


def _rotation_to(rot: Rotation, device) -> Rotation:
    return dataclasses.replace(rot, matrix=rot.matrix.to(device),
                               lam=rot.lam.to(device),
                               signs=rot.signs.to(device))


def _host_mirror(t: torch.Tensor, lead) -> bool:
    """A CPU copy of device state (a paged state's refcounts and page
    table mirror) under a card's mesh: it stays on the host."""
    return t.device.type == "cpu" and lead.type != "cpu"


def _place_shard(tree, specs, j: int, m: int, device, lead):
    """Shard j of a state's tree: K/V leaves narrowed to their heads,
    everything else copied whole; device tensors to ``device``, host
    mirrors (on the CPU under a card's lead device) kept on the host."""
    spec_of = dict(pt.flatten_with_path(specs))

    def place(path, t):
        spec = spec_of.get(path, pt.P())
        if "model" in spec:
            t = _split(t, m, j, dim=list(spec).index("model"))
        dst = t.device if _host_mirror(t, lead) else device
        return t.to(dst, copy=True).contiguous()

    return pt.tree_map_with_path(place, tree)


def _refuse_split_k(allow_split_k: bool) -> None:
    if allow_split_k:
        raise NotImplementedError(
            "allow_split_k=True needs a softmax combine across shards "
            "(ROADMAP A12d); the head split is the only serving layout")


def shard_state(state: CacheState, mesh, *, allow_split_k: bool = False):
    """``state`` laid out over ``mesh`` by ``serve_cache_specs``: a
    ``ShardedState`` when its K/V heads divide the 'model' axis, else
    ``state`` itself (every K/V leaf replicated)."""
    _refuse_split_k(allow_split_k)
    if isinstance(state, ShardedState):
        return state
    specs = pt.serve_cache_specs(state, mesh)
    if all(s == pt.P() for _, s in pt.flatten_with_path(specs)):
        return state
    devices = mesh.devices_along("model")
    lead, m = mesh.lead, len(devices)
    shards = [_place_shard(state, specs, j, m, d, lead)
              for j, d in enumerate(devices)]
    return ShardedState(shards, devices, lead, state.policy, specs)


def shard_cache(cache: dict, mesh, *, allow_split_k: bool = False) -> dict:
    """A model cache with every attention state (``attn``, and an
    encoder-decoder's ``self`` / ``cross``) passed through
    :func:`shard_state`; ``pos`` and recurrent states stay on the lead
    device (replicated: the single controller runs them once).  Identity
    without a mesh."""
    if mesh is None:
        return cache
    _refuse_split_k(allow_split_k)
    return {k: ([shard_state(st, mesh) for st in v]
                if k in CACHE_KEYS else v)
            for k, v in cache.items()}


def gather_state(state):
    """An unsharded ``CacheState`` on the lead device with the bytes of
    ``state`` (K/V leaves concatenated by head, replicated leaves from
    shard 0); a plain state as it is.  The counterpart of ``np.asarray``
    on a sharded cache."""
    if not isinstance(state, ShardedState):
        return state
    spec_of = dict(pt.flatten_with_path(state.specs))
    per = [dict(pt.flatten_with_path(s)) for s in state.shards]
    lead = state.lead

    def join(path, t):
        spec = spec_of.get(path, pt.P())
        if "model" in spec:
            return torch.cat([p[path].to(lead) for p in per],
                             dim=list(spec).index("model"))
        return t.to(t.device if _host_mirror(t, lead) else lead, copy=True)

    return pt.tree_map_with_path(join, state.shards[0])


def step_lengths(cache: dict) -> list:
    """The lengths a decode step advances beyond ``model.step_state``'s:
    those of shards 1.. of every sharded state (a captured step's warm-up
    puts them back too)."""
    out = []
    for key in CACHE_KEYS:
        for st in cache.get(key, ()):
            if isinstance(st, ShardedState):
                out += [s.length for s in st.shards[1:]
                        if isinstance(s.length, torch.Tensor)]
    return out
