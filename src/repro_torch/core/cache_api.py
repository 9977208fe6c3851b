"""KV-cache policies behind one protocol (port of
``repro/core/cache_api.py``: ``AttendBackend``, ``CacheState``, the
registry, ``policy_from_config``, ``_export_pool_pages`` /
``_seed_dense_leaf`` (:529-547), ``BF16Policy`` (:564-736),
``Int4SRFTPolicy`` (:763-1100) and ``Int8PerTokenPolicy`` (:1107-1371);
the dense, ragged and paged lifecycles of admission, chunked prefill with
token-level prefix reuse, the host prefix tier, and decode).

    pol   = get_policy("int4-srft", group=32, window=16)
    state = pol.init_state(B, Hkv, S_max, d, generator=g, device=dev)
    state = pol.prefill(state, k, v)          # bulk insert (in place)
    state = pol.update(state, k, v)           # decode append (in place)
    out   = pol.attend(q, state, backend=AttendBackend.KERNEL)

Continuous batching: ``init_state(..., ragged=True)`` gives per-row
``(B,)`` lengths (``update(..., active=)`` masks finished rows;
``insert_row`` copies a prefilled batch-1 row into a slot; ``reset_rows``
retires slots), and ``init_paged(..., n_pages, page_size)`` a paged pool
(``core/paged.py``) filled by ``insert_row_paged``.  The int4 KERNEL read
of a paged state is kernel B2; GATHER and BLOCKWISE read the gathered
per-row view.

Chunked prefill: ``prefill_chunk`` appends a prompt chunk at each row's
length (ragged or paged; W-aligned boundaries give a monolithic
prefill's bytes); ``adopt_prefix`` seeds a batch-1 row from a donor's
resident pages; ``raw_kv_view`` reads a row back in raw space (bf16: its
bytes; int4: dequantize + inverse rotation, kernel B4).

Host prefix tier: ``export_pages`` copies named pool pages to the host
(CPU tensors, one device-to-host copy per leaf) and ``import_pages``
writes such tiles into a dense batch-1 staging row, placing the bytes
``adopt_prefix`` places from the same pages while resident.

``int8-per-token`` keeps one int8 code per element and one fp32 scale per
K/V vector (no rotation); its read is GATHER only.

Speculative decoding (ref :698-720, :1012-1065): ``snapshot_rows``
copies what a verify pass's rollback needs (bf16, int8: the entry lengths;
int4: the residual rings and lengths) into fresh tensors or into
caller-owned buffers (``into=``, the fixed addresses a captured pass
writes); ``verify_attend`` scores k queries, each against its own prefix,
with GATHER's numerics; ``truncate_rows`` rolls the live state back in
place.  An int4 KERNEL verify warns once and reads with GATHER's
numerics, as the reference does: B1/B2 are single-query kernels.

The model code never branches on the scheme: a ``CacheState`` carries its
policy, and every policy conforms to ``KVCachePolicy``.  ``attend`` raises for a backend a policy does not implement; the
one switch it makes is the reference's: an int4 KERNEL read with a
``sliding_window``, which B1/B2 do not implement, is served by BLOCKWISE
after a one-time warning.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Any, Optional, Protocol, runtime_checkable

import torch

from repro_torch import resolve_device
from repro_torch.core import kvcache, paged, quant
from repro_torch.core.kvcache import BF16KVCache, QuantKVCache
from repro_torch.core.paged import PagedData
from repro_torch.core.paged import read_pages as _read_pages
from repro_torch.core.quant_attention_ref import (
    decode_attention_bf16,
    decode_attention_bf16_blockwise,
    decode_attention_quant,
    decode_attention_quant_blockwise,
    verify_attention_bf16,
    verify_attention_quant,
)
from repro_torch.core.transforms import Rotation, make_rotation
from repro_torch.kernels.srft_quant.ops import dequantize_rotate

__all__ = [
    "AttendBackend",
    "CacheState",
    "KVCachePolicy",
    "BF16Policy",
    "Int4SRFTPolicy",
    "Int4State",
    "Int8PerTokenPolicy",
    "Int8State",
    "register_policy",
    "available_policies",
    "get_policy",
    "policy_from_config",
]


class AttendBackend(enum.Enum):
    """Decode read path."""

    GATHER = "gather"  # one-shot dequant, plain PyTorch
    BLOCKWISE = "blockwise"  # flash-decode tiles, plain PyTorch
    KERNEL = "kernel"  # kernel B1 / B2 (plain versions on CPU tensors)

    @classmethod
    def parse(cls, value: "AttendBackend | str | None") -> "AttendBackend":
        if value is None:
            return cls.GATHER
        if isinstance(value, AttendBackend):
            return value
        try:
            return cls(str(value).lower())
        except ValueError:
            names = ", ".join(b.value for b in cls)
            raise ValueError(
                f"unknown attend backend {value!r} (have: {names})"
            ) from None


@dataclasses.dataclass
class CacheState:
    """A per-layer cache state that knows its own policy."""

    policy: Any
    data: Any

    @property
    def length(self):
        """A shared int, or per-row (B,) int32 (ragged and paged states)."""
        return self.data.length

    @property
    def lengths(self):
        """Alias for ragged callers."""
        return self.data.length

    @property
    def s_max(self) -> int:
        """Tokens a row can hold."""
        return getattr(self.data, "kv", self.data).s_max

    @property
    def is_ragged(self) -> bool:
        """True when ``length`` has one entry per batch row."""
        return isinstance(self.data.length, torch.Tensor)

    @property
    def is_paged(self) -> bool:
        """True when K/V live in a page pool (paged states are ragged)."""
        return isinstance(getattr(self.data, "kv", self.data), PagedData)

    def nbytes(self, *, persistent_only: bool = True,
               per_shard: bool = False) -> int:
        """Cache bytes, global-logical: the same figure whether or not the
        state is sharded over a mesh (``launch/sharded_cache.py``).
        ``per_shard=True`` counts one shard's resident bytes; on a plain
        state it changes nothing."""
        return self.policy.nbytes(self, persistent_only=persistent_only,
                                  per_shard=per_shard)


@runtime_checkable
class KVCachePolicy(Protocol):
    """What every KV-cache scheme implements (port of the reference's
    protocol, ``repro/core/cache_api.py:175-449``): the methods and their
    parameter names are the reference's, with one translation: where the
    reference takes a PRNG ``key`` the port takes a ``torch.Generator``
    (``generator``), beside the ``device`` its entry points take.  A
    policy may add keyword options after them (``snapshot_rows(into=)``,
    ``raw_kv_view(n_tokens=)``; on ``attend`` int4's ``plan_rows`` and
    ``packed_len``, and every policy's ``return_lse``).  The registered
    policies and ``launch/sharded_cache.ShardedPolicy`` (the policy of a
    state sharded over a mesh) conform.

    Lifecycle: ``init_state`` (dense; ``ragged=True`` gives per-row
    lengths) or ``init_paged`` (a page pool, always ragged); ``prefill``
    or ``prefill_chunk`` fills it, ``update`` appends one decode token a
    row (``active`` masks finished rows), ``attend`` reads; admission is
    ``insert_row`` / ``insert_row_paged`` / ``adopt_prefix``, retirement
    ``reset_rows``; a speculative pass takes ``snapshot_rows``, reads with
    ``verify_attend`` and rolls back with ``truncate_rows``; the host
    prefix tier moves pages with ``export_pages`` / ``import_pages``.
    Every write is in place (a captured CUDA graph replays fixed
    addresses), where the reference's donated pytrees are rebuilt.
    ``nbytes`` and ``compression_ratio`` are global-logical unless
    ``per_shard``."""

    name: str
    supported_backends: tuple

    def init_state(self, batch: int, n_kv_heads: int, s_max: int,
                   head_dim: int, *,
                   generator: Optional[torch.Generator] = None,
                   device=None, ragged: bool = False) -> CacheState:
        """A zeroed dense cache of ``batch`` rows of ``s_max`` tokens."""
        ...

    def init_paged(self, batch: int, n_kv_heads: int, s_max: int,
                   head_dim: int, *, n_pages: int, page_size: int,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> CacheState:
        """A zeroed paged cache: ``(n_pages, H, page_size, c)`` pools
        behind a per-row page table; raises on a misaligned page size."""
        ...

    def prefill(self, state: CacheState, k: torch.Tensor, v: torch.Tensor
                ) -> CacheState:
        """Bulk-insert a prompt ``(B, Hkv, S, d)``; every row at S."""
        ...

    def update(self, state: CacheState, k: torch.Tensor, v: torch.Tensor,
               *, active: Optional[torch.Tensor] = None) -> CacheState:
        """Append one token ``(B, Hkv, 1, d)`` at each row's length."""
        ...

    def prefill_chunk(self, state: CacheState, k: torch.Tensor,
                      v: torch.Tensor) -> CacheState:
        """Append a prompt chunk ``(B, Hkv, C, d)`` at each row's length."""
        ...

    def attend(self, q: torch.Tensor, state: CacheState, *,
               scale: Optional[float] = None,
               backend: "AttendBackend | str | None" = None,
               kv_block: int = 512,
               sliding_window: Optional[int] = None) -> torch.Tensor:
        """One-token read: ``q`` ``(B, Hq, 1, d)`` -> ``(B, Hq, 1, d)``."""
        ...

    def snapshot_rows(self, state: CacheState) -> Any:
        """What a verify pass's rollback needs, copied before its appends."""
        ...

    def verify_attend(self, q: torch.Tensor, state: CacheState, snap: Any,
                      *, scale: Optional[float] = None,
                      backend: "AttendBackend | str | None" = None,
                      kv_block: int = 512,
                      sliding_window: Optional[int] = None) -> torch.Tensor:
        """k verify queries ``(B, Hq, k, d)``, each against its prefix."""
        ...

    def truncate_rows(self, state: CacheState, new_length, snap: Any
                      ) -> CacheState:
        """Roll rows back to ``new_length`` after a verify pass."""
        ...

    def with_rotations(self, state: CacheState, rot_k: Rotation,
                       rot_v: Rotation) -> CacheState:
        """The state with (calibrated) rotations; a no-op without them."""
        ...

    def insert_row(self, state: CacheState, row: CacheState, slot
                   ) -> CacheState:
        """Admit a prefilled batch-1 ragged ``row`` into ``slot``."""
        ...

    def insert_row_paged(self, state: CacheState, row: CacheState, slot,
                         shared_pages, n_shared, n_new) -> CacheState:
        """Paged admission: share ``n_shared`` pages, fill ``n_new``."""
        ...

    def adopt_prefix(self, row: CacheState, paged: CacheState, pages,
                     n_tokens) -> CacheState:
        """Seed a dense batch-1 ``row`` from resident pages of ``paged``."""
        ...

    def export_pages(self, state: CacheState, pages) -> tuple:
        """Host copies of the named pool pages, one a pool leaf."""
        ...

    def import_pages(self, row: CacheState, payload: tuple, n_tokens
                     ) -> CacheState:
        """Seed a dense batch-1 ``row`` from exported page tiles."""
        ...

    def raw_kv_view(self, state: CacheState) -> tuple:
        """Raw-space ``(B, Hkv, S, d)`` K/V of a dense state."""
        ...

    def reset_rows(self, state: CacheState, mask) -> CacheState:
        """Retire the masked rows: lengths to 0 (paged: pages freed)."""
        ...

    def nbytes(self, state: CacheState, *, persistent_only: bool = True,
               per_shard: bool = False) -> int:
        """Cache bytes, global-logical unless ``per_shard``."""
        ...

    def compression_ratio(self, state: CacheState, *,
                          per_shard: bool = False) -> float:
        """bf16-equivalent bytes over persistent bytes."""
        ...


_REGISTRY: dict[str, type] = {}


def register_policy(name: str):
    """Class decorator: ``@register_policy("int4-srft")``."""

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        _REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


def available_policies() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_policy(name: str, **hyperparams):
    """Instantiate a registered policy; hyperparameters the scheme does not
    take (e.g. ``window`` for bf16) are dropped."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown cache policy {name!r} "
            f"(registered: {', '.join(sorted(_REGISTRY))})"
        ) from None
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in hyperparams.items() if k in fields})


def policy_from_config(cfg, policy=None):
    """An instance (returned as-is), a registry name, or None (the config
    picks "int4-srft" when ``kv_quant``, else "bf16")."""
    if policy is None:
        policy = "int4-srft" if getattr(cfg, "kv_quant", False) else "bf16"
    if isinstance(policy, str):
        return get_policy(
            policy,
            group=getattr(cfg, "kv_group", 32),
            window=getattr(cfg, "kv_window", 16),
            rotation=getattr(cfg, "rotation", "srft"),
        )
    return policy


def _leaf_bytes(*leaves: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


def _insert_row_leaf(batched: torch.Tensor, row: torch.Tensor, slot: int
                     ) -> None:
    """Row ``slot`` of a capacity-B leaf takes a batch-1 leaf, in place."""
    batched[slot] = row[0].to(batched.dtype)


def _reset_lengths(length: torch.Tensor, mask) -> None:
    """Zero the masked rows' lengths in place."""
    length.masked_fill_(
        torch.as_tensor(mask, dtype=torch.bool).to(length.device), 0)


def _check_active(state, active) -> None:
    if active is not None and not state.is_ragged:
        raise ValueError("active masks need a ragged cache "
                         "(init_state(..., ragged=True))")


def _refuse_scalar_chunk(state) -> None:
    if not state.is_ragged:
        raise ValueError("chunked prefill is a ragged/paged lifecycle "
                         "(init_state(..., ragged=True))")


def _seed_leaf(buf: torch.Tensor, tiles: torch.Tensor) -> None:
    """Positions [0, n) of a dense batch-1 leaf take a ``read_pages``
    view (1, H, n, c), in place."""
    buf[:, :, :tiles.shape[2]] = tiles.to(buf.dtype)


def _refuse_paged_prefill(state) -> None:
    if state.is_paged:
        raise NotImplementedError(
            "paged states are filled per row: prefill a dense batch-1 "
            "ragged state and admit it with insert_row_paged")


def _export_pool_pages(pd: PagedData, pages) -> tuple:
    """Host copies of the named pages of every pool leaf (the spill side
    of the host prefix tier, ref ``cache_api.py:529``): a gather along the
    page axis on the device, then one device-to-host copy per leaf.  CPU
    tensors ``(NP, H, page_size, c)``, in the policy's leaf order."""
    idx = torch.as_tensor(list(pages), dtype=torch.long).to(
        pd.pools[0].device)
    return tuple(p.index_select(0, idx).cpu() for p in pd.pools)


def _seed_dense_leaf(buf: torch.Tensor, tiles: torch.Tensor) -> None:
    """Positions [0, NP * page_size) of a dense batch-1 leaf take ``(NP, H,
    page_size, c)`` page tiles, in place (the restore side of the host
    tier, ref ``cache_api.py:540``)."""
    _seed_leaf(buf, paged.pages_to_dense(tiles.to(buf.device)))


def _copy_into(src, into):
    """A copy of ``src``: into ``into`` in place when given, else a fresh
    clone; a host int (a plain cache's length) passes through."""
    if not isinstance(src, torch.Tensor):
        return src
    return src.clone() if into is None else into.copy_(src)


def _unsupported(policy, backend: AttendBackend):
    names = ", ".join(b.value for b in policy.supported_backends)
    raise NotImplementedError(
        f"{policy.name} implements the {names} read paths in this port "
        f"(got {backend.value})"
    )


@register_policy("bf16")
@dataclasses.dataclass(frozen=True)
class BF16Policy:
    """Uncompressed bf16 cache (the paper's fp16 DynamicCache analogue)."""

    supported_backends = (AttendBackend.GATHER, AttendBackend.BLOCKWISE)

    def init_state(self, batch, n_kv_heads, s_max, head_dim, *,
                   generator: Optional[torch.Generator] = None,
                   device=None, ragged: bool = False):
        return CacheState(self, kvcache.init_bf16_cache(
            batch, n_kv_heads, s_max, head_dim, ragged=ragged,
            device=resolve_device(device)))

    def init_paged(self, batch, n_kv_heads, s_max, head_dim, *, n_pages,
                   page_size, generator: Optional[torch.Generator] = None,
                   device=None):
        return CacheState(self, paged.init_paged(
            batch, s_max, page_size=page_size, n_pages=n_pages,
            leaf_specs=((n_kv_heads, head_dim, torch.bfloat16),) * 2,
            device=resolve_device(device)))

    def with_rotations(self, state, rot_k, rot_v):
        return state  # no rotation state

    def prefill(self, state, k, v):
        _refuse_paged_prefill(state)
        kvcache.bf16_prefill(state.data, k, v)
        return state

    def update(self, state, k, v, *, active=None):
        _check_active(state, active)
        if state.is_paged:
            paged.append_token(state.data, (k, v), active)
        elif state.is_ragged:
            kvcache.bf16_decode_update_ragged(state.data, k, v, active)
        else:
            kvcache.bf16_decode_update(state.data, k, v)
        return state

    def prefill_chunk(self, state, k, v):
        """Append a prompt chunk (B, Hkv, C, d) at each row's length."""
        if state.is_paged:
            paged.append_chunk(state.data, (k, v))
        else:
            _refuse_scalar_chunk(state)
            kvcache.bf16_prefill_chunk_ragged(state.data, k, v)
        return state

    def adopt_prefix(self, row, paged, pages, n_tokens: int):
        """Seed a dense batch-1 ragged ``row`` from the donor pages
        ``pages`` of ``paged`` and set its length to ``n_tokens``;
        positions past them hold garbage that chunks overwrite."""
        d = row.data
        for buf, tiles in zip((d.k, d.v),
                              _read_pages(paged.data, pages)):
            _seed_leaf(buf, tiles)
        d.length = kvcache.all_rows_at(d.length, n_tokens)
        return row

    def export_pages(self, state, pages) -> tuple:
        """Host copies (k, v) of the named pool pages, ``(NP, Hkv, ps,
        d)`` bf16 each."""
        return _export_pool_pages(state.data, pages)

    def import_pages(self, row, payload, n_tokens: int):
        """Seed a dense batch-1 ragged ``row`` from exported page tiles
        (``export_pages``'s, from either device) and set its length: the
        bytes ``adopt_prefix`` places from the same pages while
        resident."""
        d = row.data
        for buf, tiles in zip((d.k, d.v), payload):
            _seed_dense_leaf(buf, tiles)
        d.length = kvcache.all_rows_at(d.length, n_tokens)
        return row

    def raw_kv_view(self, state, n_tokens: Optional[int] = None):
        """Raw-space (B, Hkv, n, d) K/V of a dense state's first
        ``n_tokens`` positions (all by default): its bytes."""
        n = state.s_max if n_tokens is None else n_tokens
        return state.data.k[:, :, :n], state.data.v[:, :, :n]

    def insert_row(self, state, row, slot):
        """Copy a prefilled batch-1 ragged row into ``slot`` (in place)."""
        if state.is_paged:
            raise NotImplementedError(
                "paged admission goes through insert_row_paged (the engine "
                "supplies the COW page plan)")
        d, r = state.data, row.data
        for b, x in ((d.k, r.k), (d.v, r.v), (d.length, r.length)):
            _insert_row_leaf(b, x, slot)
        return state

    def insert_row_paged(self, state, row, slot, shared_pages, n_shared,
                         n_new):
        r = row.data
        paged.insert_row(state.data, (r.k, r.v), (), r.length, slot,
                         shared_pages, n_shared, n_new)
        return state

    def reset_rows(self, state, mask):
        if state.is_paged:
            paged.reset_rows(state.data, mask)
        else:
            _reset_lengths(state.data.length, mask)
        return state

    def attend(self, q, state, *, scale=None, backend=None, kv_block=512,
               sliding_window=None, return_lse=False):
        """``return_lse``: also the (B, Hq, 1) log-sum-exp of the scores
        (a read split by position combines its parts by it)."""
        backend = AttendBackend.parse(backend)
        if backend not in self.supported_backends:
            _unsupported(self, backend)
        data = state.data
        if state.is_paged:
            k, v = paged.gather_view(data)
            data = BF16KVCache(k, v, data.length)
        if backend is AttendBackend.BLOCKWISE:
            return decode_attention_bf16_blockwise(
                q, data, scale=scale, sliding_window=sliding_window,
                kv_block=kv_block, return_lse=return_lse)
        return decode_attention_bf16(q, data, scale=scale,
                                     sliding_window=sliding_window,
                                     return_lse=return_lse)

    def rollback_leaves(self, state) -> tuple:
        """The live tensors a verify pass's rollback rewrites: the
        lengths (position-addressed appends need nothing else)."""
        return (state.data.length,)

    def snapshot_rows(self, state, into=None):
        """The entry lengths, copied (into ``into`` when given)."""
        return _copy_into(state.data.length, into)

    def verify_attend(self, q, state, snap, *, scale=None, backend=None,
                      kv_block=512, sliding_window=None):
        """k queries (B, Hq, k, d) against a state holding all k appended
        tokens; ``snap`` is :meth:`snapshot_rows`'s.  Every backend reads
        with GATHER's numerics, as the reference's."""
        backend = AttendBackend.parse(backend)
        if backend not in self.supported_backends:
            _unsupported(self, backend)
        data = state.data
        if state.is_paged:
            k, v = paged.gather_view(data)
            data = BF16KVCache(k, v, data.length)
        return verify_attention_bf16(q, data, base_len=snap, scale=scale,
                                     sliding_window=sliding_window)

    def truncate_rows(self, state, new_length, snap):
        """Roll back to ``new_length`` in place: a length decrement."""
        kvcache.set_length(state.data, new_length)
        return state

    def nbytes(self, state, *, persistent_only: bool = True,
               per_shard: bool = False):
        """Cache bytes; for a paged state the whole pool (the allocation),
        plus the page table and refcounts unless ``persistent_only``.
        ``per_shard`` is a no-op on a plain state (a sharded state's
        policy counts one shard)."""
        d = state.data
        if state.is_paged:
            n = _leaf_bytes(*d.pools)
            return n if persistent_only else n + paged.meta_nbytes(d)
        return _leaf_bytes(d.k, d.v)

    def bf16_equiv_bytes(self, state) -> int:
        """The bytes of the same K/V in bf16 (the ratio's numerator)."""
        return self.nbytes(state)

    def compression_ratio(self, state, *, per_shard: bool = False) -> float:
        return 1.0


_KERNEL_SLIDING_WINDOW_WARNED = False


def _warn_kernel_sliding_window() -> None:
    """Once per process, as the reference (``cache_api.py:968-977``): a
    request must not die of a backend/feature mismatch, so the read goes
    to BLOCKWISE, the kernel's tiling in plain PyTorch."""
    global _KERNEL_SLIDING_WINDOW_WARNED
    if not _KERNEL_SLIDING_WINDOW_WARNED:
        _KERNEL_SLIDING_WINDOW_WARNED = True
        warnings.warn(
            "int4-srft: the B1/B2 kernels do not implement sliding_window; "
            "falling back to the BLOCKWISE read path for this and "
            "subsequent windowed reads", RuntimeWarning, stacklevel=3)


_KERNEL_VERIFY_WARNED = False


def _warn_kernel_verify() -> None:
    """Once per process, as the reference (``cache_api.py:1024-1036``):
    a verify read is multi-query and B1/B2 are single-query, so the pass
    reads with GATHER's numerics."""
    global _KERNEL_VERIFY_WARNED
    if not _KERNEL_VERIFY_WARNED:
        _KERNEL_VERIFY_WARNED = True
        warnings.warn(
            "int4-srft: the B1/B2 kernels do not implement multi-query "
            "speculative verify; falling back to the GATHER read path for "
            "this and subsequent verify passes", RuntimeWarning,
            stacklevel=3)


@dataclasses.dataclass
class Int4State:
    """int4 policy state: packed KV (a ``QuantKVCache``, or a ``PagedData``
    for a paged state) + the per-layer rotations that made it."""

    kv: Any
    rot_k: Rotation
    rot_v: Rotation

    @property
    def length(self):
        return self.kv.length


@register_policy("int4-srft")
@dataclasses.dataclass(frozen=True)
class Int4SRFTPolicy:
    """SRFT rotation + per-channel lambda + int4 per-group codes + fp32
    residual window (paper §7.1-7.2).  Writes go through kernel B3; the
    KERNEL read through kernel B1, or B2 on a paged state."""

    supported_backends = (AttendBackend.GATHER, AttendBackend.BLOCKWISE,
                          AttendBackend.KERNEL)

    group: int = 32
    window: int = 16
    rotation: str = "srft"  # srft | srht | identity

    def _rotations(self, generator, head_dim, device):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return (make_rotation(self.rotation, generator, head_dim, device),
                make_rotation(self.rotation, generator, head_dim, device))

    def init_state(self, batch, n_kv_heads, s_max, head_dim, *,
                   generator: Optional[torch.Generator] = None,
                   device=None, ragged: bool = False):
        device = resolve_device(device)
        return CacheState(self, Int4State(
            kvcache.init_cache(batch, n_kv_heads, s_max, head_dim,
                               group=self.group, window=self.window,
                               ragged=ragged, device=device),
            *self._rotations(generator, head_dim, device)))

    def init_paged(self, batch, n_kv_heads, s_max, head_dim, *, n_pages,
                   page_size, generator: Optional[torch.Generator] = None,
                   device=None):
        if head_dim % 2 or head_dim % self.group:
            raise ValueError(
                f"head_dim={head_dim} must divide 2 and group={self.group}")
        if page_size % self.window:
            raise ValueError(
                f"page_size={page_size} must be a multiple of the int4 flush "
                f"window W={self.window}: a residual flush writes a W-token "
                f"slab at a W-aligned offset, and the multiple keeps the "
                f"slab inside one (tail) page")
        device = resolve_device(device)
        ng = head_dim // self.group
        return CacheState(self, Int4State(
            paged.init_paged(
                batch, s_max, page_size=page_size, n_pages=n_pages,
                leaf_specs=((n_kv_heads, head_dim // 2, torch.uint8),
                            (n_kv_heads, ng, torch.float32)) * 2,
                residual_specs=((n_kv_heads, self.window, head_dim,
                                 torch.float32),) * 2,
                device=device),
            *self._rotations(generator, head_dim, device)))

    def with_rotations(self, state, rot_k, rot_v):
        return CacheState(self, dataclasses.replace(state.data, rot_k=rot_k,
                                                    rot_v=rot_v))

    def prefill(self, state, k, v):
        _refuse_paged_prefill(state)
        d = state.data
        kvcache.prefill(d.kv, d.rot_k, d.rot_v, k, v)
        return state

    def update(self, state, k, v, *, active=None):
        _check_active(state, active)
        d = state.data
        if state.is_paged:
            paged.int4_update_paged(d.kv, d.rot_k, d.rot_v, k, v, active)
        elif state.is_ragged:
            kvcache.decode_update_ragged(d.kv, d.rot_k, d.rot_v, k, v,
                                         active)
        else:
            kvcache.decode_update(d.kv, d.rot_k, d.rot_v, k, v)
        return state

    def prefill_chunk(self, state, k, v):
        """Append a prompt chunk (B, Hkv, C, d) at each row's length: the
        W-aligned bulk through B3, a final chunk's tail into the ring."""
        d = state.data
        if state.is_paged:
            paged.int4_prefill_chunk_paged(d.kv, d.rot_k, d.rot_v, k, v)
        else:
            _refuse_scalar_chunk(state)
            kvcache.prefill_chunk_ragged(d.kv, d.rot_k, d.rot_v, k, v)
        return state

    def adopt_prefix(self, row, paged, pages, n_tokens: int):
        """Seed a dense batch-1 ragged ``row`` from donor pages.
        ``n_tokens`` must be W-aligned (the engine's contract): every
        adopted byte then comes from packed storage and the residual ring
        keeps its zeros, the state a monolithic prefill of those tokens
        leaves at a flush boundary."""
        kv = row.data.kv
        leaves = (kv.k_packed, kv.k_scales, kv.v_packed, kv.v_scales)
        for buf, tiles in zip(leaves,
                              _read_pages(paged.data.kv, pages)):
            _seed_leaf(buf, tiles)
        kv.length = kvcache.all_rows_at(kv.length, n_tokens)
        return row

    def export_pages(self, state, pages) -> tuple:
        """Host copies (k_packed, k_scales, v_packed, v_scales) of the
        named pool pages, ``(NP, Hkv, ps, c)`` each."""
        return _export_pool_pages(state.data.kv, pages)

    def import_pages(self, row, payload, n_tokens: int):
        """Seed a dense batch-1 ragged ``row`` from exported page tiles and
        set its length.  ``n_tokens`` is page-aligned (the engine's
        contract) and ``page_size % W == 0``, so the residual ring keeps
        its zeros: the flush-boundary argument of :meth:`adopt_prefix`."""
        kv = row.data.kv
        for buf, tiles in zip((kv.k_packed, kv.k_scales, kv.v_packed,
                               kv.v_scales), payload):
            _seed_dense_leaf(buf, tiles)
        kv.length = kvcache.all_rows_at(kv.length, n_tokens)
        return row

    def raw_kv_view(self, state, n_tokens: Optional[int] = None):
        """Raw-space (B, Hkv, n, d) fp32 K/V of a dense state's first
        ``n_tokens`` positions (all by default, valid below the packed
        length): unpack, dequantize and inverse-rotate through kernel B4
        with the folded inverse (its plain version on the CPU).  The
        reference dequantizes and applies ``rot.inverse`` (lambda first),
        so its fp32 sums run in another order: after the cast to bf16 an
        element may differ by one ulp."""
        if state.is_paged:
            raise ValueError("raw_kv_view reads a dense state (a staging "
                             "row), not a page pool")
        d = state.data
        kv = d.kv
        n = kv.s_max if n_tokens is None else n_tokens
        return tuple(
            dequantize_rotate(p[:, :, :n], s[:, :, :n], rot,
                              group=self.group)
            for p, s, rot in ((kv.k_packed, kv.k_scales, d.rot_k),
                              (kv.v_packed, kv.v_scales, d.rot_v)))

    def insert_row(self, state, row, slot):
        """Copy a prefilled batch-1 ragged row into ``slot`` (in place).
        The rotations are shared model constants and stay the batched
        state's: the row must have been built with the same ones."""
        if state.is_paged:
            raise NotImplementedError(
                "paged admission goes through insert_row_paged (the engine "
                "supplies the COW page plan)")
        kv, r = state.data.kv, row.data.kv
        for f in ("k_packed", "k_scales", "v_packed", "v_scales",
                  "k_residual", "v_residual", "length"):
            _insert_row_leaf(getattr(kv, f), getattr(r, f), slot)
        return state

    def insert_row_paged(self, state, row, slot, shared_pages, n_shared,
                         n_new):
        r = row.data.kv
        paged.insert_row(
            state.data.kv, (r.k_packed, r.k_scales, r.v_packed, r.v_scales),
            (r.k_residual, r.v_residual), r.length, slot, shared_pages,
            n_shared, n_new)
        return state

    def reset_rows(self, state, mask):
        kv = state.data.kv
        if state.is_paged:
            paged.reset_rows(kv, mask)
        else:
            _reset_lengths(kv.length, mask)
        return state

    def _dense_kv_view(self, pd: PagedData) -> QuantKVCache:
        """Per-row dense view of a paged int4 state (GATHER, BLOCKWISE)."""
        kp, ks, vp, vs = paged.gather_view(pd)
        return QuantKVCache(kp, ks, vp, vs, *pd.residual, pd.length)

    def attend(self, q, state, *, scale=None, backend=None, kv_block=512,
               sliding_window=None, plan_rows=None, packed_len=None,
               return_lse=False):
        """``plan_rows``: B1/B2's split-K plan's row count (the kernel
        wrappers' ``plan_rows``); the other reads ignore it.  A dense
        state's read takes ``packed_len`` (default ``L - L mod W``) and
        ``return_lse`` (also the (B, Hq, 1) log-sum-exp of the scores):
        what a read split by position over shards needs."""
        backend = AttendBackend.parse(backend)
        d = state.data
        if backend is AttendBackend.KERNEL and sliding_window is not None:
            _warn_kernel_sliding_window()
            backend = AttendBackend.BLOCKWISE
        if backend is AttendBackend.KERNEL:
            from repro_torch.kernels.quant_attention import (
                decode_attention_kernel,
                decode_attention_kernel_paged,
            )

            if state.is_paged:
                return decode_attention_kernel_paged(
                    q, d.kv, d.rot_k, d.rot_v, scale=scale,
                    plan_rows=plan_rows)
            return decode_attention_kernel(q, d.kv, d.rot_k, d.rot_v,
                                           scale=scale, blk=kv_block,
                                           plan_rows=plan_rows,
                                           packed_len=packed_len,
                                           return_lse=return_lse)
        kv = self._dense_kv_view(d.kv) if state.is_paged else d.kv
        if backend is AttendBackend.BLOCKWISE:
            return decode_attention_quant_blockwise(
                q, kv, d.rot_k, d.rot_v, scale=scale,
                sliding_window=sliding_window, kv_block=kv_block,
                packed_len=packed_len, return_lse=return_lse)
        return decode_attention_quant(q, kv, d.rot_k, d.rot_v, scale=scale,
                                      sliding_window=sliding_window,
                                      packed_len=packed_len,
                                      return_lse=return_lse)

    def rollback_leaves(self, state) -> tuple:
        """The live tensors a verify pass's rollback rewrites: the K and V
        residual rings (a mod-W overwrite structure) and the lengths."""
        kv = state.data.kv
        if state.is_paged:
            return (*kv.residual, kv.length)
        return (kv.k_residual, kv.v_residual, kv.length)

    def snapshot_rows(self, state, into=None):
        """(k ring, v ring, lengths) at pass entry, copied (into the three
        buffers of ``into`` when given): the appends that follow write the
        live rings in place."""
        into = (None,) * 3 if into is None else into
        return tuple(_copy_into(t, b)
                     for t, b in zip(self.rollback_leaves(state), into))

    def verify_attend(self, q, state, snap, *, scale=None, backend=None,
                      kv_block=512, sliding_window=None):
        """k queries (B, Hq, k, d) against a state holding all k appended
        tokens, with GATHER's numerics; KERNEL warns once first."""
        if AttendBackend.parse(backend) is AttendBackend.KERNEL:
            _warn_kernel_verify()
        d = state.data
        snap_k, snap_v, base_len = snap
        kv = self._dense_kv_view(d.kv) if state.is_paged else d.kv
        return verify_attention_quant(
            q, kv, d.rot_k, d.rot_v, snap_k_res=snap_k, snap_v_res=snap_v,
            base_len=base_len, scale=scale, sliding_window=sliding_window)

    def truncate_rows(self, state, new_length, snap):
        """Roll back to ``new_length`` in place: the rings rewound, the
        lengths set; packed storage untouched."""
        kv = state.data.kv
        snap_k, snap_v, base_len = snap
        if state.is_paged:
            for ring, saved in zip(kv.residual, (snap_k, snap_v)):
                kvcache.rewind_residual(ring, saved, base_len, new_length)
            kvcache.set_length(kv, new_length)
        else:
            kvcache.truncate_rows(kv, new_length, snap_k, snap_v, base_len)
        return state

    def nbytes(self, state, *, persistent_only: bool = True,
               per_shard: bool = False):
        """Persistent bytes: packed codes + scales (for a paged state the
        whole pool: that is the allocation).  ``persistent_only=False``
        adds the O(W) fp32 residual window and, paged, the page table and
        refcounts.  The rotations (model constants) are never counted.
        ``per_shard`` is a no-op on a plain state."""
        kv = state.data.kv
        if state.is_paged:
            n = _leaf_bytes(*kv.pools)
            if not persistent_only:
                n += _leaf_bytes(*kv.residual) + paged.meta_nbytes(kv)
            return n
        n = _leaf_bytes(kv.k_packed, kv.k_scales, kv.v_packed, kv.v_scales)
        if not persistent_only:
            n += _leaf_bytes(kv.k_residual, kv.v_residual)
        return n

    def bf16_equiv_bytes(self, state) -> int:
        """The bytes of the same K/V vectors in bf16."""
        kv = state.data.kv
        k_packed = kv.pools[0] if state.is_paged else kv.k_packed
        d = k_packed.shape[-1] * 2
        n_vectors = k_packed.numel() // (d // 2)
        return 2 * 2 * n_vectors * d

    def compression_ratio(self, state, *, per_shard: bool = False) -> float:
        """bf16-equivalent bytes / persistent bytes (paper §4.5)."""
        return self.bf16_equiv_bytes(state) / self.nbytes(state)


# ---------------------------------------------------------------------------
# int8 per token (the third scheme: the registry carries new policies)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Int8State:
    """int8 policy state: one int8 code per element and one fp32 scale per
    K/V vector."""

    k_codes: torch.Tensor  # (B, Hkv, S_max, d) int8
    k_scales: torch.Tensor  # (B, Hkv, S_max, 1) f32
    v_codes: torch.Tensor
    v_scales: torch.Tensor
    length: Any = 0  # a shared int, or (B,) int32 when ragged

    @property
    def s_max(self) -> int:
        return self.k_codes.shape[-2]

    def leaves(self) -> tuple:
        return (self.k_codes, self.k_scales, self.v_codes, self.v_scales)


def _quant8(x: torch.Tensor) -> tuple:
    q = quant.quantize_per_token(x, 8)
    return q.codes, q.scales  # (..., d) int8, (..., 1) f32


def _dequant8(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return quant.dequantize_per_token(quant.Quantized(codes, scales, 8))


@register_policy("int8-per-token")
@dataclasses.dataclass(frozen=True)
class Int8PerTokenPolicy:
    """Symmetric int8 with one fp32 scale per K/V vector (paper Table 5's
    per_token row at 8 bits; no rotation), built on
    ``quant.quantize_per_token``: ~1.94x smaller than bf16 at d = 128.
    The read is GATHER only (dequantize, then the bf16 read); BLOCKWISE
    and KERNEL raise, as the reference's (``cache_api.py:1299-1305``).
    Every write is an index write at per-row offsets, in place, so a
    captured decode step or verify pass takes the policy unchanged."""

    supported_backends = (AttendBackend.GATHER,)

    def init_state(self, batch, n_kv_heads, s_max, head_dim, *,
                   generator: Optional[torch.Generator] = None,
                   device=None, ragged: bool = False):
        dev = resolve_device(device)
        shape_c = (batch, n_kv_heads, s_max, head_dim)
        shape_s = (batch, n_kv_heads, s_max, 1)

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        length = (torch.zeros((batch,), dtype=torch.int32, device=dev)
                  if ragged else 0)
        return CacheState(self, Int8State(
            z(shape_c, torch.int8), z(shape_s, torch.float32),
            z(shape_c, torch.int8), z(shape_s, torch.float32), length))

    def init_paged(self, batch, n_kv_heads, s_max, head_dim, *, n_pages,
                   page_size, generator: Optional[torch.Generator] = None,
                   device=None):
        return CacheState(self, paged.init_paged(
            batch, s_max, page_size=page_size, n_pages=n_pages,
            leaf_specs=((n_kv_heads, head_dim, torch.int8),
                        (n_kv_heads, 1, torch.float32)) * 2,
            device=resolve_device(device)))

    def with_rotations(self, state, rot_k, rot_v):
        return state  # rotation-free scheme

    @staticmethod
    def _codes(k, v) -> tuple:
        return (*_quant8(k), *_quant8(v))

    def prefill(self, state, k, v):
        _refuse_paged_prefill(state)
        d = state.data
        S = k.shape[-2]
        kvcache._check_room(d, S)
        for buf, val in zip(d.leaves(), self._codes(k, v)):
            buf[:, :, :S] = val
        d.length = kvcache.all_rows_at(d.length, S)
        return state

    def update(self, state, k, v, *, active=None):
        """Append one token (B, Hkv, 1, d) at each row's length: paged
        through ``paged.append_token``, ragged by a per-row index write
        (clamped into the buffer, as ``dynamic_update_slice``)."""
        _check_active(state, active)
        d = state.data
        vals = self._codes(k, v)
        if state.is_paged:
            paged.append_token(d, vals, active)
        elif state.is_ragged:
            for buf, val in zip(d.leaves(), vals):
                kvcache.chunk_write(buf, val, d.length)
            d.length.copy_(kvcache.advance(d.length, active))
        else:
            kvcache._check_room(d, d.length + 1)
            for buf, val in zip(d.leaves(), vals):
                buf[:, :, d.length] = val[:, :, 0]
            d.length += 1
        return state

    def prefill_chunk(self, state, k, v):
        """Append a prompt chunk (B, Hkv, C, d) at each row's length;
        quantization is per token, so chunk boundaries move no byte."""
        d = state.data
        vals = self._codes(k, v)
        if state.is_paged:
            paged.append_chunk(d, vals)
        else:
            _refuse_scalar_chunk(state)
            for buf, val in zip(d.leaves(), vals):
                kvcache.chunk_write(buf, val, d.length)
            d.length.add_(k.shape[-2])
        return state

    def adopt_prefix(self, row, paged, pages, n_tokens: int):
        """Seed a dense batch-1 ragged ``row`` from donor pages and set
        its length to ``n_tokens``."""
        d = row.data
        for buf, tiles in zip(d.leaves(),
                              _read_pages(paged.data, pages)):
            _seed_leaf(buf, tiles)
        d.length = kvcache.all_rows_at(d.length, n_tokens)
        return row

    def export_pages(self, state, pages) -> tuple:
        """Host copies (k_codes, k_scales, v_codes, v_scales) of the named
        pool pages, ``(NP, Hkv, ps, c)`` each."""
        return _export_pool_pages(state.data, pages)

    def import_pages(self, row, payload, n_tokens: int):
        """Seed a dense batch-1 ragged ``row`` from exported page tiles and
        set its length."""
        d = row.data
        for buf, tiles in zip(d.leaves(), payload):
            _seed_dense_leaf(buf, tiles)
        d.length = kvcache.all_rows_at(d.length, n_tokens)
        return row

    def raw_kv_view(self, state, n_tokens: Optional[int] = None):
        """Raw-space (B, Hkv, n, d) fp32 K/V of a dense state's first
        ``n_tokens`` positions (all by default): codes times scales."""
        if state.is_paged:
            raise ValueError("raw_kv_view reads a dense state (a staging "
                             "row), not a page pool")
        d = state.data
        n = d.s_max if n_tokens is None else n_tokens
        return (_dequant8(d.k_codes[:, :, :n], d.k_scales[:, :, :n]),
                _dequant8(d.v_codes[:, :, :n], d.v_scales[:, :, :n]))

    def insert_row(self, state, row, slot):
        """Copy a prefilled batch-1 ragged row into ``slot`` (in place)."""
        if state.is_paged:
            raise NotImplementedError(
                "paged admission goes through insert_row_paged (the engine "
                "supplies the COW page plan)")
        d, r = state.data, row.data
        for b, x in zip((*d.leaves(), d.length), (*r.leaves(), r.length)):
            _insert_row_leaf(b, x, slot)
        return state

    def insert_row_paged(self, state, row, slot, shared_pages, n_shared,
                         n_new):
        r = row.data
        paged.insert_row(state.data, r.leaves(), (), r.length, slot,
                         shared_pages, n_shared, n_new)
        return state

    def reset_rows(self, state, mask):
        if state.is_paged:
            paged.reset_rows(state.data, mask)
        else:
            _reset_lengths(state.data.length, mask)
        return state

    def _dequantized(self, state) -> BF16KVCache:
        """The whole cache dequantized to fp32, per row (a paged state
        through its gathered view): the GATHER read's operand."""
        d = state.data
        kc, ks, vc, vs = (paged.gather_view(d) if state.is_paged
                          else d.leaves())
        return BF16KVCache(_dequant8(kc, ks), _dequant8(vc, vs), d.length)

    def attend(self, q, state, *, scale=None, backend=None, kv_block=512,
               sliding_window=None, return_lse=False):
        """``return_lse``: also the (B, Hq, 1) log-sum-exp of the
        scores."""
        backend = AttendBackend.parse(backend)
        if backend is not AttendBackend.GATHER:
            raise NotImplementedError(
                f"int8-per-token implements only the GATHER read path "
                f"(got {backend.value}); tiled dequant is int4-only")
        return decode_attention_bf16(q, self._dequantized(state),
                                     scale=scale,
                                     sliding_window=sliding_window,
                                     return_lse=return_lse)

    def rollback_leaves(self, state) -> tuple:
        """The live tensors a verify pass's rollback rewrites: the lengths
        alone (per-token codes are position-addressed: an append at t
        overwrites t's codes and scale whole)."""
        return (state.data.length,)

    def snapshot_rows(self, state, into=None):
        """The entry lengths, copied (into ``into`` when given)."""
        return _copy_into(state.data.length, into)

    def verify_attend(self, q, state, snap, *, scale=None, backend=None,
                      kv_block=512, sliding_window=None):
        """k queries (B, Hq, k, d) against a state holding all k appended
        tokens; every backend reads with GATHER's numerics, as the
        reference's."""
        AttendBackend.parse(backend)
        return verify_attention_bf16(q, self._dequantized(state),
                                     base_len=snap, scale=scale,
                                     sliding_window=sliding_window)

    def truncate_rows(self, state, new_length, snap):
        """Roll back to ``new_length`` in place: a length decrement."""
        kvcache.set_length(state.data, new_length)
        return state

    def nbytes(self, state, *, persistent_only: bool = True,
               per_shard: bool = False):
        """Codes + scales; for a paged state the whole pool, plus the page
        table and refcounts unless ``persistent_only``.  ``per_shard`` is
        a no-op on a plain state."""
        d = state.data
        if state.is_paged:
            n = _leaf_bytes(*d.pools)
            return n if persistent_only else n + paged.meta_nbytes(d)
        return _leaf_bytes(*d.leaves())

    def bf16_equiv_bytes(self, state) -> int:
        """The bytes of the same K/V elements in bf16."""
        k_codes = state.data.pools[0] if state.is_paged \
            else state.data.k_codes
        return 2 * 2 * k_codes.numel()

    def compression_ratio(self, state, *, per_shard: bool = False) -> float:
        """bf16-equivalent bytes / persistent bytes."""
        return self.bf16_equiv_bytes(state) / self.nbytes(state)
