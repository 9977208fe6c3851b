"""A KV cache sharded over a mesh's 'model' axis, by head or (split-K)
by position: the port's counterpart of a ``CacheState`` that GSPMD
partitioned by ``serve_cache_specs`` (ref ``repro/launch/engine.py:213-
239``, ``batch_engine.py:508-528``, ``partitioning.py:232-268``,
DESIGN.md §16).

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

Split-K (``shard_cache(..., allow_split_k=True)``, ``Engine`` only):
where the KV heads do not divide the axis, the specs give the sequence
axis of the dense seq-major leaves to 'model', and shard j holds
positions ``[j*S/m, (j+1)*S/m)`` of every such leaf plus a copy of the
residual rings, lengths and rotations.  Every shard holds every head, so
a write is made once at full width on the lead (B3 for the prompt's
bulk and every W-flush, the ring rows' rotation, the int8 codes) and its
bytes go to the shard or shards that own their positions: by slicing
where the offset is a host int, by a masked window write where the
lengths live on the device (a captured step cannot tell the owner on
the host; a write that straddles a boundary lands in both shards).  The
cache gathered along the sequence is the unsharded cache bit for bit.
A read runs on every shard over its own segment (``plen_j = clamp(plen
- j*S/m, 0, S/m)``; shard 0 alone folds the residual window), returns
its output and its log-sum-exp (B1's optional output on a KERNEL read),
and the lead combines the m parts by ``exp(lse_j - max_j lse_j)``: the
reference's GSPMD reduction, numerically correct, not bit-exact
(``partitioning.py:232-236``).  A shard with nothing to read has lse
-1e30, so weight exactly 0.

Speculative decoding (``Engine.generate_spec`` / ``decode_spec``) runs on
such a state too.  A verify pass's k appends are k decode appends; its
read takes query i at ``L_i = L0 + i + 1`` through the decode read's own
function (:func:`_seq_read`), shard 0 folding the ring as query i saw it
(``quant_attention_ref.verify_rings``), so each verify query equals the
split decode read at ``L_i`` bit for bit (with GATHER's numerics: there
is no multi-query B1).  The rollback is every shard's own: each holds
the global lengths and a full copy of the rings, so the snapshot, the
ring rewind and the length set run shard by shard, and packed storage is
left as it is (a rolled-back flush that straddles two shards lies past
the packed length in both, is masked by every read, and the next
readable flush rewrites it whole in both).

The other operations (chunked prefill, the raw view, admission, the host
tier, a sliding-window read) raise on a state split by position: the
reference reaches them only through its ``BatchEngine``, which never
splits by position (``repro/launch/batch_engine.py:518``), and no config
sets a sliding window.

Where the specs give every KV leaf ``P()`` (MQA, a head count the axis
does not divide without split-K, a 'model' axis of 1) the cache stays
one unsharded state on the lead device: replication computes the same
bytes.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import torch

from repro_torch.core import kvcache, paged
from repro_torch.core.cache_api import (
    AttendBackend,
    CacheState,
    _unsupported,
    _warn_kernel_verify,
)
from repro_torch.core.quant_attention_ref import verify_rings
from repro_torch.core.transforms import Rotation
from repro_torch.kernels.srft_quant.ops import quantize_rotated, rotate_quantize
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


def _splits_sequence(specs) -> bool:
    """True when the specs put 'model' on a leaf's sequence axis (-2)."""
    return any(len(s) >= 2 and s[-2] == "model"
               for _, s in pt.flatten_with_path(specs))


class ShardedState:
    """One ``CacheState`` per 'model' index (``shards``), shard j on
    ``devices[j]``; ``specs`` are the serving specs of the unsharded
    state (which dim of each leaf is split: the KV heads, or with split-K
    the sequence, ``seq_split``).  Quacks like a ``CacheState`` for the
    model and the engines."""

    def __init__(self, shards: list, devices: list, lead: torch.device,
                 inner, specs):
        self.shards = shards
        self.devices = devices
        self.lead = lead
        self.specs = specs
        self.seq_split = _splits_sequence(specs)
        self.policy = ShardedPolicy(inner)

    @property
    def m(self) -> int:
        return len(self.shards)

    @property
    def span(self) -> int:
        """Positions a shard holds: ``s_max / m`` under split-K, else all."""
        return self.shards[0].s_max

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
        return self.span * (self.m if self.seq_split else 1)

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

    # -- the protocol's members, spelled out (``KVCachePolicy``'s
    # isinstance check does not look through ``__getattr__``): ``inner``'s
    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def supported_backends(self) -> tuple:
        return self.inner.supported_backends

    def init_state(self, batch, n_kv_heads, s_max, head_dim, *,
                   generator=None, device=None, ragged=False):
        """An unsharded state (``shard_state`` lays it out)."""
        return self.inner.init_state(batch, n_kv_heads, s_max, head_dim,
                                     generator=generator, device=device,
                                     ragged=ragged)

    def init_paged(self, batch, n_kv_heads, s_max, head_dim, *, n_pages,
                   page_size, generator=None, device=None):
        """An unsharded paged state (``shard_state`` lays it out)."""
        return self.inner.init_paged(batch, n_kv_heads, s_max, head_dim,
                                     n_pages=n_pages, page_size=page_size,
                                     generator=generator, device=device)

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
        if state.seq_split:
            _seq_prefill(self.inner, state, k, v)
        else:
            self._write(self.inner.prefill, state, k, v)
        return state

    def update(self, state, k, v, *, active=None):
        if state.seq_split:
            _seq_update(self.inner, state, k, v, active)
        else:
            self._write(self.inner.update, state, k, v, active=active)
        return state

    def prefill_chunk(self, state, k, v):
        _refuse_seq(state, "prefill_chunk")
        self._write(self.inner.prefill_chunk, state, k, v)
        return state

    # -- reads
    def attend(self, q, state, *, scale=None, backend=None, kv_block=512,
               sliding_window=None, **kw):
        """Per shard; where the policy rotates, the query's fold and the
        output's inverse rotation run once at full width on the lead, and
        each shard reads in rotated space (``_RotatedSpace``), through B1
        or B2 on a KERNEL read with the unsplit read's split-K plan
        (``plan_rows`` = B·Hkv), so every shard's rows equal the unsplit
        read's.  A state split by position reads by :func:`_seq_attend`."""
        kw.update(scale=scale, backend=backend, kv_block=kv_block,
                  sliding_window=sliding_window)
        if state.seq_split:
            return _seq_attend(self.inner, q, state, **kw)
        if not hasattr(state.data, "rot_k"):
            return self._gather_heads(self._each(
                state, lambda j, s, d: self.inner.attend(
                    self._heads(q, state, j, d), s, **kw)), state)
        rk, rv = _lead_rotations(state)
        qf = q.float() @ rk.folded_query_matrix().T
        kw["plan_rows"] = q.shape[0] * state.m * _kv_heads(state.shards[0])
        out = self._gather_heads(self._each(
            state, lambda j, s, d: self.inner.attend(
                self._heads(qf, state, j, d), _RotatedSpace.over(s), **kw)),
            state)
        return rv.inverse(out).to(q.dtype)

    def verify_attend(self, q, state, snap, *, scale=None, backend=None,
                      kv_block=512, sliding_window=None):
        """As :meth:`attend`, one verify query at a time for the fold and
        the inverse, as the unsplit read does them.  A state split by
        position reads by :func:`_seq_verify`."""
        kw = dict(scale=scale, backend=backend, kv_block=kv_block,
                  sliding_window=sliding_window)
        if state.seq_split:
            return _seq_verify(self.inner, q, state, snap, **kw)
        if not hasattr(state.data, "rot_k"):
            return self._gather_heads(self._each(
                state, lambda j, s, d: self.inner.verify_attend(
                    self._heads(q, state, j, d), s, snap[j], **kw)), state)
        rk, rv = _lead_rotations(state)
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
        _refuse_seq(state, "raw_kv_view")
        per = self._each(state, lambda j, s, d: self.inner.raw_kv_view(
            s, n_tokens))
        return tuple(self._gather_heads(list(leaves), state)
                     for leaves in zip(*per))

    # -- speculative rollback
    def snapshot_rows(self, state, into=None):
        """Every shard's snapshot (its lengths, and its ring copies where
        the policy has rings), into ``into[j]`` when given."""
        return [self.inner.snapshot_rows(
                    s, into=None if into is None else into[j])
                for j, s in enumerate(state.shards)]

    def rollback_leaves(self, state) -> tuple:
        """Every shard's leaves: a captured pass puts back shards 1..'s
        lengths and rings too."""
        return tuple(itertools.chain.from_iterable(
            self.inner.rollback_leaves(s) for s in state.shards))

    def truncate_rows(self, state, new_length, snap):
        """Every shard rolled back by its own snapshot (under split-K its
        ring copies rewound and its lengths set; packed storage kept)."""
        self._each(state, lambda j, s, d: self.inner.truncate_rows(
            s, _to(new_length, d), snap[j]))
        return state

    # -- admission and retirement
    def insert_row(self, state, row, slot):
        _refuse_seq(state, "insert_row")
        for s, r in zip(state.shards, row.shards):
            self.inner.insert_row(s, r, slot)
        return state

    def insert_row_paged(self, state, row, slot, shared_pages, n_shared,
                         n_new):
        _refuse_seq(state, "insert_row_paged")
        for s, r in zip(state.shards, row.shards):
            self.inner.insert_row_paged(s, r, slot, shared_pages, n_shared,
                                        n_new)
        return state

    def adopt_prefix(self, row, paged, pages, n_tokens: int):
        _refuse_seq(row, "adopt_prefix")
        for r, s in zip(row.shards, paged.shards):
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
        _refuse_seq(state, "export_pages")
        per = [self.inner.export_pages(s, pages) for s in state.shards]
        return tuple(torch.cat(leaves, dim=1) for leaves in zip(*per))

    def import_pages(self, row, payload, n_tokens: int):
        _refuse_seq(row, "import_pages")
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
        is one shard's resident bytes (K/V / m, metadata in full; under
        split-K the seq-major leaves / m and the residual rings in
        full)."""
        if per_shard:
            return self.inner.nbytes(state.shards[0],
                                     persistent_only=persistent_only)
        if state.seq_split:  # the rings are replicated: counted once
            first = state.shards[0]
            rings = (self.inner.nbytes(first, persistent_only=persistent_only)
                     - self.inner.nbytes(first, persistent_only=True))
            return rings + sum(self.inner.nbytes(s, persistent_only=True)
                               for s in state.shards)
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


# ---------------------------------------------------------------------------
# Split-K: a state split by position
# ---------------------------------------------------------------------------

def _refuse_seq(state, what: str) -> None:
    if isinstance(state, ShardedState) and state.seq_split:
        raise NotImplementedError(
            f"{what} on a cache split by position over shards (split-K) is "
            f"not served: the reference reaches it only through "
            f"BatchEngine, which never splits by position "
            f"(repro/launch/batch_engine.py:518); split-K serves Engine's "
            f"prefill, decode and speculative decoding")


def _holder(data):
    """The object whose ``length`` a dense state keeps (int4: its kv)."""
    return getattr(data, "kv", data)


def _seq_leaves(data) -> tuple:
    """The seq-major leaves of a dense state, in the order of the values
    its write produces."""
    if hasattr(data, "kv"):
        kv = data.kv
        return (kv.k_packed, kv.k_scales, kv.v_packed, kv.v_scales)
    if hasattr(data, "leaves"):  # int8: codes and scales
        return data.leaves()
    return (data.k, data.v)


def _plain_values(inner, k, v) -> tuple:
    """A bf16 or int8 write's values, computed once on the lead."""
    codes = getattr(inner, "_codes", None)
    return (k, v) if codes is None else codes(k, v)


def _window_write(buf, val, off, do) -> None:
    """Row b of a shard's leaf ``buf`` (B, H, n, c) takes ``val[b]`` (H,
    C, c) at its local positions ``[off_b, off_b + C)`` where they fall in
    ``[0, n)`` (and ``do[b]``, when given); every other position keeps
    its bytes.  ``off`` (B,) may lie outside the shard: the C positions
    written are a window of distinct ones clamped into it (so no two
    writes of one call hit one address), and a position of the window the
    span does not cover writes its current bytes back."""
    C, n = val.shape[2], buf.shape[2]
    if C > n:
        raise ValueError(f"a {C}-token write into shards of {n} positions: "
                         f"split-K needs s_max / m >= the flush window")
    dev = buf.device
    pos = off.clamp(0, n - C)[:, None] + torch.arange(C, device=dev)
    src = pos - off[:, None]
    ok = (src >= 0) & (src < C)
    if do is not None:
        ok = ok & do[:, None]
    rows = torch.arange(buf.shape[0], device=dev)[:, None]
    new = val.transpose(1, 2)[rows, src.clamp(0, C - 1)].to(buf.dtype)
    buf[rows, :, pos] = torch.where(ok[..., None, None], new,
                                    buf[rows, :, pos])


def _seq_put(state, vals, off, do=None) -> None:
    """Write ``vals`` (one (B, H, C, c) tensor a seq-major leaf, on the
    lead) at global positions ``[off, off + C)``: a host int (sliced into
    the owning shards), or per row (B,) on the lead device with an
    optional (B,) ``do`` mask (a masked window write on every shard)."""
    n = state.span
    for j, (s, dev) in enumerate(zip(state.shards, state.devices)):
        lo = j * n
        for buf, val in zip(_seq_leaves(s.data), vals):
            if isinstance(off, int):
                C = val.shape[2]
                a, b = max(off, lo), min(off + C, lo + n)
                if a < b:
                    buf[:, :, a - lo:b - lo] = val[:, :, a - off:b - off].to(
                        dev, buf.dtype)
            else:
                _window_write(buf, val.to(dev), off.to(dev) - lo,
                              None if do is None else do.to(dev))


def _lead_rotations(state) -> tuple:
    d = state.shards[0].data
    return tuple(_rotation_to(getattr(d, side), state.lead)
                 for side in ("rot_k", "rot_v"))


def _seq_prefill(inner, state, k, v) -> None:
    """The unsplit prefill's bytes, placed by position: the bulk through
    B3 once on the lead, the residual tail into every shard's ring copy,
    every shard's length to S."""
    S = k.shape[-2]
    kvcache._check_room(state, S)
    if hasattr(state.data, "rot_k"):
        W, g = inner.window, inner.group
        plen = (S // W) * W
        rots = _lead_rotations(state)
        if plen:
            (kp, ks), (vp, vs) = (rotate_quantize(x[..., :plen, :], rot,
                                                  group=g)
                                  for rot, x in zip(rots, (k, v)))
            _seq_put(state, (kp, ks, vp, vs), 0)
        if S - plen:
            tail = [rot.forward_at(x, kvcache.tail_from(plen))
                    for rot, x in zip(rots, (k, v))]
            for s, dev in zip(state.shards, state.devices):
                kv = s.data.kv
                kv.k_residual[:, :, :S - plen] = tail[0].to(dev)
                kv.v_residual[:, :, :S - plen] = tail[1].to(dev)
    else:
        _seq_put(state, _plain_values(inner, k, v), 0)
    for s in state.shards:
        h = _holder(s.data)
        h.length = kvcache.all_rows_at(h.length, S)


def _seq_update(inner, state, k, v, active) -> None:
    """One decode token per row, the unsplit update's bytes placed by
    position.  int4: the token's rotation once on the lead, its ring slot
    written in every shard's copy; B3 quantizes the lead's ring (on a
    ragged state every step, as the unsplit update does) and the slab
    lands where the window just filled.  Lengths advance on every shard."""
    L = state.length
    ragged = isinstance(L, torch.Tensor)
    if active is not None and not ragged:
        raise ValueError("active masks need a ragged cache "
                         "(init_state(..., ragged=True))")
    S = state.s_max
    if not ragged:
        kvcache._check_room(state, L + 1)
    if hasattr(state.data, "rot_k"):
        W, g = inner.window, inner.group
        tok = [rot.forward_at(x, kvcache.TOKEN)
               for rot, x in zip(_lead_rotations(state), (k, v))]
        for s, dev in zip(state.shards, state.devices):
            kv = s.data.kv
            for ring, t in zip((kv.k_residual, kv.v_residual), tok):
                if ragged:
                    kvcache.ring_write(ring, t.to(dev), kv.length % W)
                else:
                    ring[:, :, L % W] = t.to(dev)
        if ragged or L % W == W - 1:
            ring = state.shards[0].data.kv
            slab = (*quantize_rotated(ring.k_residual, group=g),
                    *quantize_rotated(ring.v_residual, group=g))
            if ragged:
                _seq_put(state, slab, (L + 1 - W).clamp(0, S - W),
                         do=L % W == W - 1)
            else:
                _seq_put(state, slab, L + 1 - W)
    else:
        _seq_put(state, _plain_values(inner, k, v),
                 L.clamp(max=S - 1) if ragged else L)
    for s, dev in zip(state.shards, state.devices):
        h = _holder(s.data)
        if ragged:
            h.length.copy_(kvcache.advance(
                h.length, None if active is None else active.to(dev)))
        else:
            h.length = h.length + 1


def _segment(x, j: int, n: int):
    """How much of a global prefix length ``x`` falls in shard j's span
    ``[j*n, (j+1)*n)``: an int, or per row."""
    if isinstance(x, int):
        return min(max(x - j * n, 0), n)
    return (x - j * n).clamp(0, n)


def _with_length(shard: CacheState, length) -> CacheState:
    """A view of ``shard`` whose length is ``length`` (no copy)."""
    d = shard.data
    if hasattr(d, "kv"):
        d = dataclasses.replace(d, kv=dataclasses.replace(d.kv,
                                                          length=length))
    else:
        d = dataclasses.replace(d, length=length)
    return CacheState(shard.policy, d)


def _with_rings(shard: CacheState, ring_k, ring_v) -> CacheState:
    """A view of an int4 ``shard`` whose residual rings are ``ring_k`` /
    ``ring_v`` (no copy)."""
    d = shard.data
    return CacheState(shard.policy, dataclasses.replace(
        d, kv=dataclasses.replace(d.kv, k_residual=ring_k,
                                  v_residual=ring_v)))


def _combine(outs: list, lses: list) -> torch.Tensor:
    """The parts of one read over disjoint segments, each (B, Hq, 1, d)
    fp32 with its (B, Hq, 1) log-sum-exp, on one device: ``sum_j
    exp(lse_j - M) out_j / sum_j exp(lse_j - M)``, ``M = max_j lse_j``.
    An empty part (lse -1e30) weighs exactly 0 beside any valid one; the
    largest part weighs 1, so the denominator is at least 1."""
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(dim=0))
    return (w[..., None] * torch.stack(outs)).sum(dim=0) \
        / w.sum(dim=0)[..., None]


def _refuse_window(sliding_window) -> None:
    if sliding_window is not None:
        raise NotImplementedError(
            "a sliding-window read under split-K is not served: no config "
            "of the reference or the port sets a sliding window")


def _seq_attend(inner, q, state, *, sliding_window=None, plan_rows=None,
                **kw) -> torch.Tensor:
    """A decode read of a state split by position (:func:`_seq_read` at
    the state's length, over its live rings).  A KERNEL read runs B1 on
    each shard with its own split plan (``plan_rows`` is not taken)."""
    _refuse_window(sliding_window)
    return _seq_read(inner, q, state, state.length, None, **kw)


def _seq_read(inner, q, state, L, rings, **kw) -> torch.Tensor:
    """One query (B, Hq, 1, d) read against a state split by position as
    a decode step at length ``L`` (a host int, or per row on the lead)
    reads it.  Shard j reads its segment, ``plen_j = clamp(plen - j*n,
    0, n)`` packed positions (bf16 and int8: ``clamp(L - j*n, 0, n)``),
    and shard 0 alone folds the residual window (``tlen_0 = plen_0 + L -
    plen``), over ``rings`` (k, v) when given, else its live rings; each
    returns its output in fp32 and its log-sum-exp, and the lead
    combines them (:func:`_combine`).  int4: the query's fold and the
    output's inverse rotation run once at full width on the lead and the
    shards read in rotated space."""
    n, lead = state.span, state.lead
    rotated = hasattr(state.data, "rot_k")
    if rotated:
        rk, rv = _lead_rotations(state)
        plen = L - L % inner.window
        qr = q.float() @ rk.folded_query_matrix().T
    else:
        plen, qr = L, q.float()
    outs, lses = [], []
    for j, (s, dev) in enumerate(zip(state.shards, state.devices)):
        seg = _to(_segment(plen, j, n), dev)
        if rotated:
            tlen = seg + _to(L - plen, dev) if j == 0 else seg
            view = _with_length(s, tlen)
            if j == 0 and rings is not None:
                view = _with_rings(view, *rings)
            out, lse = inner.attend(qr.to(dev), _RotatedSpace.over(view),
                                    packed_len=seg, return_lse=True, **kw)
        else:
            out, lse = inner.attend(qr.to(dev), _with_length(s, seg),
                                    return_lse=True, **kw)
        outs.append(out.to(lead))
        lses.append(lse.to(lead))
    out = _combine(outs, lses)
    return (rv.inverse(out) if rotated else out).to(q.dtype)


def _seq_verify(inner, q, state, snap, *, backend=None, sliding_window=None,
                **kw) -> torch.Tensor:
    """The k-query verify read (B, Hq, k, d) of a state split by position
    that holds all k appended tokens; ``snap`` is every shard's entry
    snapshot.  Query i is :func:`_seq_read` at ``L_i = L0 + i + 1``, the
    length the decode step that appended its token read at, with shard
    0's rings as that step saw them (``verify_rings``: the snapshot's
    slots where this pass wrote past what query i may see); packed
    storage is append-only within a pass and the bf16 / int8 buffers are
    position-addressed, so each query's read is the split decode read at
    ``L_i`` bit for bit.  Every backend reads with GATHER's numerics, as
    the unsplit verify does (KERNEL warns once: B1 is single-query)."""
    _refuse_window(sliding_window)
    backend = AttendBackend.parse(backend)
    rotated = hasattr(state.data, "rot_k")
    if rotated:
        if backend is AttendBackend.KERNEL:
            _warn_kernel_verify()
        snap_k, snap_v, base = snap[0]
        kv = state.shards[0].data.kv
    else:
        if inner.name == "bf16" and backend not in inner.supported_backends:
            _unsupported(inner, backend)
        base = snap[0]
    outs = []
    for i in range(q.shape[2]):
        L_i = base + (i + 1)
        rings = None
        if rotated:
            rings = verify_rings(kv.k_residual, kv.v_residual, snap_k,
                                 snap_v, L_i - L_i % inner.window, base)
        outs.append(_seq_read(inner, q[:, :, i:i + 1], state, L_i, rings,
                              backend=AttendBackend.GATHER, **kw))
    return torch.cat(outs, dim=2)


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


def shard_state(state: CacheState, mesh, *, allow_split_k: bool = False):
    """``state`` laid out over ``mesh`` by ``serve_cache_specs``: a
    ``ShardedState`` when its K/V heads divide the 'model' axis or, with
    ``allow_split_k``, when its positions do (dense states only), else
    ``state`` itself (every K/V leaf replicated)."""
    if isinstance(state, ShardedState):
        return state
    specs = pt.serve_cache_specs(state, mesh, allow_split_k=allow_split_k)
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
    return {k: ([shard_state(st, mesh, allow_split_k=allow_split_k)
                 for st in v]
                if k in CACHE_KEYS else v)
            for k, v in cache.items()}


def gather_state(state):
    """An unsharded ``CacheState`` on the lead device with the bytes of
    ``state`` (K/V leaves concatenated by head, or by position under
    split-K, replicated leaves from shard 0); a plain state as it is.  The counterpart of ``np.asarray``
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
