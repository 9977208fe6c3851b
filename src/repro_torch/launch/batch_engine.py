"""Continuous batching: ragged multi-request serving over a slot cache
(port of ``repro/launch/batch_engine.py``: ``Request``, ``Completion``
and ``BatchEngine`` with monolithic admission (:1129-1236, :1497-1528)
and chunked admission with token-level prefix reuse (:138-160, :258-290,
:564-600, :1252-1300, :1303-1400, :1635-1688), the paged page plan with
its page-aligned copy-on-write prefix index and token-level donor index
(:687-770), the host prefix tier (:366-381, :406-416, :480-488,
:772-830, :890-927, :1282-1345), slot release (:772-824), LRU recompute
preemption (:826-878, :1409-1457), the decode chunk (:945-977,
:1705-1777), the speculative decode chunk (:211-230, :350-364,
:474-478, :686-692, :979-1063, :1074-1085, :1238), and what the serving
front-end needs: the engine lock, step listeners and tracing (:295-315,
:461-471, :1086-1127, :1689-1703), packed admission (:606-652,
:1531-1633)).

``BatchEngine`` keeps a fixed-capacity slot cache (one ragged
``CacheState`` per layer: per-row lengths) and a host-side scheduler:

  * **admit**: a queued request is prefilled alone into a batch-1 ragged
    row that shares the slot cache's rotations, then copied into a free
    slot (``policy.insert_row``); the first token is drawn from the
    prefill logits.
  * **decode**: the whole batch advances ``chunk`` tokens.  One decode
    step (the model step, the sampler, the budget, alive and EOS masks)
    reads and writes fixed device buffers: the last token, the
    ``active`` mask and the per-row budgets.  On a card that step is
    captured once in a CUDA graph (``launch/graphs.py``, the counterpart
    of the reference's ``_chunk_fn`` scan) and a chunk is ``n_steps``
    replays; ``graph=False``, and the CPU, call it eagerly instead.
    Finished rows are masked (their lengths stand still), each step's
    token and valid flag land in column i of a (capacity, chunk) buffer,
    and that buffer is read back once per chunk.  Between chunks the
    host writes the masks into their buffers; admission, COW sharing and
    preemption rewrite the cache and the page table in place.
  * **retire**: finished slots get ``policy.reset_rows`` and return to
    the free list.

Chunked admission (``prefill_chunk=C``) makes admission a pending state:
each scheduler quantum spends at most ``prefill_budget`` prompt tokens,
in C-token chunks through ``model.prefill_chunk`` on a batch-1 staging
row, and then runs the decode chunk as usual, so live streams advance
every quantum while a long prompt is admitted.  Chunk boundaries are
W-aligned (and page-aligned when paged), so each policy's
``prefill_chunk`` writes a monolithic prefill's bytes, and the chunk's
queries attend raw bf16 side buffers: chunked and monolithic admission
give the same tokens.  Paged chunked admissions also reuse prefixes at
token level: the engine keeps resident prompts' tokens beside their
pages, finds the longest shared prefix (aligned down to W, at least one
page, at most the prompt less one token), seeds the staging row from the
donor's pages (``policy.adopt_prefix``) and its raw buffers from
``policy.raw_kv_view`` (for int4 kernel B4: dequantize + inverse
rotation), and chunks only the rest.  bf16 reuse is bit-exact; int4 reuse
reads the dequantized prefix, the bytes every decode step reads
(cache-consistent, not bit-exact).  A preemption continuation never
reuses.  The staging row and raw buffers live outside the captured
decode step, and admission leaves every slot-cache buffer at its
address.

The host prefix tier (``offload_bytes=``, paged and chunked only) keeps
retired prompts' pages in host RAM (``launch/prefix_store.py``), and on
disk with ``offload_dir=``.  When the last reference to a registered
prompt page is about to drop (retirement, preemption, ``cancel_all``),
the page's bytes are exported (``policy.export_pages``, one device-to-host
copy per leaf and layer) and put under the page's key.  A chunked
admission walks the prompt's page keys from the start
(``_find_host_prefix``); when the host tier reaches deeper than a
resident donor, the pages are copied to the card in one copy per leaf,
imported into every layer of the staging row (``policy.import_pages``)
and read back into the raw buffers as a device hit is (int4: B4), and
only the rest is chunked.  The restored bytes are the donor's, so the
stream equals the one a resident donor would have served.

Paged mode (``paged=True``) swaps the dense slot stripes for a page pool
(``core/paged.py``): admission allocates only the pages a request needs,
requests whose prompts share a page-aligned prefix map the same physical
pages copy-on-write (a host-side prefix index keyed by the prefix's token
bytes), and when the pool cannot fit the next request the least recently
admitted live slot is preempted to the front of the queue as a recompute
continuation (prompt + tokens so far, the last sampled token resumed in
the token buffer).  ``Completion`` stitches the carried tokens back on.
The allocator lives on the host, so the scheduler reads its page counts
and tables without a device readback.

Self-speculative decoding (``spec_k=k``, greedy only): each step of a
decode chunk becomes one draft-verify-accept-rollback pass that advances
every live row by 1..k tokens.  Each slot keeps its drafter history
(prompt + sampled tokens) on the device, seeded at admission; a pass
drafts k - 1 tokens per row (``engine.draft_tokens``), verifies the k-token
blocks in one ``LM.decode_verify``, keeps each row's confirmed prefix plus
one (clamped to its budget, cut after an EOS) and rolls every row back to
its own length (``LM.truncate_cache``).  On a card the pass is the
captured step, and a chunk writes a (capacity, chunk x k) token/valid
grid that the same extraction loop reads.  A request needs k - 1 tokens
of slack under ``s_max`` (and in its pages): a pass appends before it
rolls back.  ``n_drafted`` / ``n_accepted`` count draft positions.

Packed admission (``admit_packed``, the serving front-end's): k prompts
of one exact length are prefilled as one batch-k staging cache, and
each row is sliced out (``_slice_row``) and inserted as a monolithic
admission's row is, in slot order, its first token drawn in row order.

Thread safety and tracing (the serving front-end, ``launch/server``):
``submit``, ``step``, ``admit_packed``, ``cancel_all`` and ``pool_stats``
take ``lock``, so every device touch of the engine, the decode graph's
capture included, happens under it; ``step_listeners`` get each
non-empty (events, completions) pair under the lock, host data only.
``trace`` is a ``TraceRecorder`` (disabled by default).  Spans of the
reference's are host clock: ``decode.chunk`` (and ``engine.step``) end
after the chunk's readback, a device sync, as the reference's do;
``engine.prefill``, ``prefill.packed`` and ``prefill.chunk`` end when
their launches return and add no sync, so they time the host's side of
the work, which may include a wait in a synchronous upload (the
reference's paged ``engine.prefill`` alone ends after a sync, its device
pool's readback, which the port's host pool does not need).  The
``first_token`` mark follows the first token's readback in
``_post_insert`` in both packages, so time to first token means the same
in each.  The port adds two categories.  ``host`` spans split the turn
between chunks: ``step.admit`` (the admission pass, empty or not) and
``step.scatter`` (tokens to streams, retirements and resets after the
readback) inside ``engine.step``; ``decode.upload`` (the masks' copies),
``decode.enqueue`` (the replays' launches) and ``decode.readback``
inside ``decode.chunk``.  ``device`` spans are device clock (CUDA
events; ``tracing.DeviceClock``): ``decode.device`` from just before a
chunk's mask copies to its last device write (``steps``, ``dev_ms``,
and ``gap_ms``, the device time since the previous chunk's end, which
holds whatever ran between the chunks, an admission's prefill too), and
``prefill.device`` for each monolithic, packed (``rids``, ``rows``) and
chunked prefill (``rid``, ``tokens``, ``dev_ms``), whose ``dev_ms`` is
also each request's ``prefill_s`` (a packed group charges every row the
whole prefill).  Their events are recorded only while the recorder is
enabled and resolved after readbacks the engine makes anyway: the
chunk's, for every span queued before it, and the first token's in
``_post_insert``.  Tracing adds no device sync.

Sampling is greedy, or by temperature from the explicit ``generator``.

Multi-device serving (``mesh=``, a ``launch/mesh.py`` mesh; ref
``batch_engine.py:185-201``, ``:326-340``, ``:494-528``, DESIGN.md §16):
the slot cache, every staging row (monolithic, chunked, packed) and
every restore target pass through ``_shard_cache_tree``, which splits
each attention state by KV head over the 'model' axis
(``launch/sharded_cache.py``); params and the token buffers pass through
``_replicate_tree`` and stay on the lead device, where the scheduler,
the projections and the sampler run once.  Every cache operation goes
through the state's own policy (``st.policy``), which for a sharded state
runs shard by shard, so each option works under a mesh unchanged, and
streams and cache bytes equal the unsharded engine's.  A KERNEL read
runs B1 or B2 on each shard's heads.  A mesh whose shards lie on more
than one card steps eagerly.

    eng = BatchEngine(model, params, capacity=4, s_max=4608,
                      policy="int4-srft", backend="kernel", paged=True,
                      prefill_chunk=256,  # None: monolithic admission
                      spec_k=None,  # 4: speculative passes of 4 tokens
                      offload_bytes=None)  # 2**28: a 256 MiB host tier
    for c in eng.run([Request(rid=0, prompt=toks, max_new_tokens=64)]):
        ...  # Completion(rid, prompt_len, tokens, finish_reason)
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTENTION_FAMILIES
from repro_torch.core.cache_api import AttendBackend, CacheState
from repro_torch.core.paged import NULL_PAGE
from repro_torch.launch.engine import (
    GREEDY,
    Sampler,
    mesh_allows_graph,
    verify_pass,
)
from repro_torch.launch.graphs import StepGraph
from repro_torch.launch.partitioning import replicate_tree
from repro_torch.launch.prefix_store import PrefixStore
from repro_torch.launch.sharded_cache import (
    ShardedState,
    shard_cache,
    step_lengths,
)

__all__ = ["Request", "Completion", "BatchEngine"]


@dataclasses.dataclass
class Request:
    """One generation request.  ``max_new_tokens`` counts every sampled
    token, the one drawn from the prefill logits included.  ``resume_tok``
    is engine-internal (paged preemption): the continuation's last sampled
    token, which resumes in the token buffer instead of being drawn."""

    rid: int
    prompt: Any  # (S,) int array
    max_new_tokens: int
    resume_tok: Optional[int] = None


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: np.ndarray  # (n_generated,) int32
    finish_reason: str  # "length" | "eos" | "cancelled"


@dataclasses.dataclass
class _PendingAdmission:
    """One in-flight chunked admission: the batch-1 staging ``row``, the
    raw bf16 K/V side buffers its chunks attend ((n_layers, 1, Hkv,
    n_total, hd)), the prompt tokens already in the row (``n_done``,
    reused ones included) and the last chunk's logits."""

    req: Request
    slot: int
    row: Any
    raw_k: torch.Tensor
    raw_v: torch.Tensor
    n_done: int
    n_total: int
    logits: Any = None
    reused_tokens: int = 0


def _leaves(obj) -> Iterator[torch.Tensor]:
    """The tensors of a staging-cache tree (dicts, lists, ``CacheState``
    data, dataclasses), in a fixed order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)
    elif isinstance(obj, CacheState):
        yield from _leaves(obj.data)
    elif isinstance(obj, ShardedState):
        for s in obj.shards:
            yield from _leaves(s)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))


def _rebuild(obj, new: Iterator[torch.Tensor]):
    """``obj`` with its tensors (``_leaves`` order) taken from ``new``."""
    if isinstance(obj, torch.Tensor):
        return next(new)
    if isinstance(obj, dict):
        return {k: _rebuild(v, new) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(v, new) for v in obj)
    if isinstance(obj, CacheState):
        return CacheState(obj.policy, _rebuild(obj.data, new))
    if isinstance(obj, ShardedState):
        return obj.map_shards(lambda s: _rebuild(s, new))
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _rebuild(getattr(obj, f.name), new)
            for f in dataclasses.fields(obj)})
    return obj


class BatchEngine:
    """Continuous-batching engine for one (model, policy, backend,
    sampler) configuration.  ``eos_id`` is an early-stop token (None =
    length only).  The decode chunk is the scheduling quantum.
    ``device`` must be the model's (``cuda`` unless ``"cpu"`` is asked
    for).  ``graph`` (default: on a card) replays a captured decode
    step; ``graph=False`` runs it eagerly, and a CPU engine refuses
    ``graph=True``.  ``prefill_chunk`` (None: monolithic admission) and
    ``prefill_budget`` (default: one chunk per quantum) turn on chunked
    admission, and ``prefix_reuse`` its token-level reuse when paged.
    ``spec_k`` (None: plain decode) turns on speculative decoding.
    ``offload_bytes`` (None: no host tier) bounds the host prefix tier's
    RAM, and ``offload_dir`` gives it a disk tier.  ``trace`` is a
    ``TraceRecorder`` (default: a disabled one).  ``mesh`` shards the KV
    cache by head (see the module docstring); its lead device must be
    ``device``."""

    def __init__(self, model, params, *, capacity: int, s_max: int,
                 policy=None, backend: "AttendBackend | str | None" = None,
                 sampler: Optional[Sampler] = None, kv_block: int = 512,
                 chunk: int = 8, eos_id: Optional[int] = None, rots=None,
                 generator: Optional[torch.Generator] = None,
                 paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None, device=None,
                 prefill_chunk: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 prefix_reuse: bool = True, spec_k: Optional[int] = None,
                 offload_bytes: Optional[int] = None,
                 offload_dir: Optional[str] = None, trace=None, mesh=None,
                 graph: Optional[bool] = None):
        if model.cfg.family not in ATTENTION_FAMILIES:
            raise NotImplementedError(
                f"ragged slot caches need a pure-attention family (got "
                f"{model.cfg.family}: recurrent state has no per-row length "
                f"semantics); serve it single-stream through Engine")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine device {self.device} != model device "
                             f"{model.device}")
        on_card = self.device.type == "cuda"
        if graph and not on_card:
            raise ValueError(f"graph=True needs a CUDA engine (got "
                             f"{self.device}); the CPU steps eagerly")
        on_card = on_card and mesh_allows_graph(mesh, graph)
        self.graph = on_card if graph is None else graph
        self.mesh = mesh
        self.model = model
        self.params = self._replicate_tree(params)
        self.capacity = capacity
        self.policy = model.cache_policy(policy)
        self.backend = None if backend is None else AttendBackend.parse(backend)
        self.sampler = sampler if sampler is not None else GREEDY
        self.kv_block = kv_block
        self.chunk = chunk
        self.eos_id = eos_id
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(0))
        self.spec_k = spec_k
        if spec_k is not None:
            self._check_spec(spec_k)

        self.paged = paged
        if paged:
            # logical extent is whole pages; the pool defaults to the dense
            # slot footprint + the null page -- a smaller n_pages
            # oversubscribes it (LRU preemption when it runs dry)
            s_max += (-s_max) % page_size
            self.page_size = page_size
            self.max_pages = s_max // page_size
            self.n_pages = (capacity * self.max_pages + 1
                            if n_pages is None else n_pages)
            if self.n_pages < self.max_pages + 1:
                raise ValueError(
                    f"n_pages={self.n_pages} cannot hold even one full row "
                    f"({self.max_pages} pages + the null page)")
        self.s_max = s_max
        self._check_chunking(prefill_chunk, prefill_budget)
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = (prefill_budget if prefill_budget is not None
                               else prefill_chunk)
        self.prefix_reuse = prefix_reuse
        self._check_offload(offload_bytes, prefill_chunk)
        self.prefix_store = (None if offload_bytes is None else
                             PrefixStore(offload_bytes, offload_dir))
        self._pending: Optional[_PendingAdmission] = None
        self.n_prefill_chunks = 0
        self.n_reused_tokens = 0

        # the serving front-end's thread-safe step API: every entry that
        # touches the device or the scheduler's state takes this lock, and
        # listeners get each non-empty (events, completions) pair under it
        self.lock = threading.RLock()
        self.step_listeners: list[Callable[[list, list], None]] = []
        if trace is None:
            # lazy: repro_torch.launch.server imports this module
            from repro_torch.launch.server.tracing import TraceRecorder
            trace = TraceRecorder(capacity=1, enabled=False)
        self.trace = trace
        self._clock = None  # the device clock, made once tracing is on
        self._slice_axes: Optional[tuple] = None

        self.cache = self._shard_cache_tree(model.init_cache(
            capacity, s_max, policy=self.policy, rots=rots, ragged=True,
            n_pages=self.n_pages if paged else None,
            page_size=page_size if paged else None))
        # every admission row is built with the slot cache's rotations
        # (an insert_row requirement)
        first = self.cache["attn"][0].data
        self._rots = None if not hasattr(first, "rot_k") else [
            (st.data.rot_k, st.data.rot_v) for st in self.cache["attn"]]
        # the step's fixed device buffers: the last sampled token, the
        # live mask, the decode steps left, and a chunk's tokens and valid
        # flags by step; the host keeps its own copies of the masks
        dev = self.device
        self.tok = torch.zeros((capacity, 1), dtype=torch.long, device=dev)
        self._active = torch.zeros((capacity,), dtype=torch.bool, device=dev)
        self._budget = torch.zeros((capacity,), dtype=torch.int32, device=dev)
        self._toks = torch.zeros((capacity, chunk), dtype=torch.long,
                                 device=dev)
        self._valid = torch.zeros((capacity, chunk), dtype=torch.bool,
                                  device=dev)
        self._step_graph: Optional[StepGraph] = None
        if spec_k is not None:
            self._init_spec(spec_k)
        self.active = np.zeros((capacity,), bool)
        self.budget = np.zeros((capacity,), np.int32)  # decode steps left
        self._slot_req: list[Optional[Request]] = [None] * capacity
        self._slot_toks: list[list[int]] = [[] for _ in range(capacity)]
        self._queue: deque[Request] = deque()

        if paged:
            # host views of layer 0's allocator (every layer's pool makes
            # the same choices); the prefix index maps page-aligned prompt
            # prefixes to resident pages, and the token-level index
            # resident prompts to their tokens and pages (reuse below a
            # page boundary); admission sequence numbers pick the LRU
            # preemption victim; _carried/_orig stitch preempted streams
            # back together
            self._prefix_pages: dict[bytes, int] = {}
            self._prefix_seqs: dict[bytes, tuple[np.ndarray, np.ndarray]] \
                = {}
            self._slot_seq = [0] * capacity
            self._admit_seq = 0
            self._carried: dict[int, list[int]] = {}
            self._orig: dict[int, tuple[int, int]] = {}
            self.n_preemptions = 0
            self.peak_pages = 0
            # the host tier's traffic: device COW hit, host restore or
            # miss, counted once per chunked admission
            self.n_spilled_pages = 0
            self.n_restored_pages = 0
            self.n_restored_tokens = 0
            self.n_reuse_hits_device = 0
            self.n_reuse_hits_host = 0
            self.n_reuse_misses = 0
            self._sync_pool()
        # the tier that first admitted each live request (device, host,
        # miss; "none" for dense engines), folded into tier_outcomes by
        # finish reason when it ends
        self._admit_tier: dict[int, str] = {}
        self.tier_outcomes: dict[str, dict[str, int]] = {}

    @property
    def trace(self):
        return self._trace

    @trace.setter
    def trace(self, rec) -> None:
        # the serving front-end swaps in its recorder after construction;
        # the host tier records into the same one
        self._trace = rec
        if self.prefix_store is not None:
            self.prefix_store.trace = rec

    def _marks(self):
        """The engine's ``DeviceClock`` while the recorder is on (made at
        first use), else None."""
        if not self._trace.enabled:
            return None
        if self._clock is None:
            from repro_torch.launch.server.tracing import DeviceClock
            self._clock = DeviceClock(self.device)
        return self._clock

    def _resolve(self) -> None:
        """Called after a readback: record the device spans that ended."""
        if self._clock is not None and self._clock.pending:
            self._clock.resolve(self._trace)

    def _check_spec(self, spec_k: int) -> None:
        """The reference's validation (``batch_engine.py:214-230``)."""
        if self.sampler.temperature != 0.0:
            raise ValueError(
                "spec_k requires greedy sampling (temperature == 0): "
                "exact-match acceptance against the verify argmax is what "
                "keeps per-row output bit-identical")
        if spec_k < 2:
            raise ValueError(f"spec_k must be >= 2, got {spec_k}")
        W = getattr(self.policy, "window", None)
        if W is not None and spec_k > W:
            raise ValueError(
                f"spec_k={spec_k} must be <= the policy flush window W={W}: "
                f"a verify pass appends at most one residual-ring wrap "
                f"(DESIGN.md §13)")

    def _check_offload(self, offload_bytes, prefill_chunk) -> None:
        """The reference's conditions (``batch_engine.py:366-381``)."""
        if offload_bytes is not None and not self.paged:
            raise ValueError(
                "offload_bytes requires paged=True: the host tier stores "
                "evicted pool pages behind the prefix index")
        if offload_bytes is not None and prefill_chunk is None:
            raise ValueError(
                "offload_bytes requires chunked admission (prefill_chunk): "
                "a host-tier restore seeds the staging row and resumes "
                "prefill after the restored tokens -- monolithic admission "
                "has no resume path")

    def _record_tier(self, rid: int, tier: str) -> None:
        """The first admission wins: a preemption continuation keeps the
        tier its request was first admitted from."""
        self._admit_tier.setdefault(rid, tier)

    def _count_outcome(self, rid: int, reason: str) -> None:
        tier = self._admit_tier.pop(rid, "none")
        by = self.tier_outcomes.setdefault(tier, {})
        by[reason] = by.get(reason, 0) + 1

    def _init_spec(self, k: int) -> None:
        """The speculative pass's fixed device buffers: per-slot drafter
        history (capacity s_max + k: a row holds at most s_max - k + 1
        tokens and a pass writes k wide at its length) and length, the
        drafted / accepted counters of a chunk, the per-layer snapshots,
        and a chunk's (capacity, chunk x k) token/valid grid."""
        dev, cap = self.device, self.capacity
        self._hist = torch.zeros((cap, self.s_max + k), dtype=torch.long,
                                 device=dev)
        self._hlen = torch.zeros((cap,), dtype=torch.long, device=dev)
        self._spec_counts = torch.zeros((2,), dtype=torch.long, device=dev)
        self._snaps = [st.policy.snapshot_rows(st)
                       for st in self.cache["attn"]]
        self._toks = torch.zeros((cap, self.chunk * k), dtype=torch.long,
                                 device=dev)
        self._valid = torch.zeros((cap, self.chunk * k), dtype=torch.bool,
                                  device=dev)
        self.n_drafted = 0  # draft positions scored (the bonus excluded)
        self.n_accepted = 0  # draft positions kept

    @property
    def n_rejected(self) -> int:
        """Speculative draft positions rolled back (drafted - accepted)."""
        if self.spec_k is None:
            return 0
        return self.n_drafted - self.n_accepted

    def _check_chunking(self, prefill_chunk, prefill_budget) -> None:
        """Chunk boundaries are W-aligned (a chunk then writes monolithic
        bytes) and, paged, page-aligned (``page_size % W == 0`` is
        ``init_paged``'s check, so that implies the first)."""
        self._align = max(int(getattr(self.policy, "window", 1) or 1), 1)
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}")
            if self.paged and prefill_chunk % self.page_size:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be a multiple of "
                    f"page_size={self.page_size} (chunk boundaries are page "
                    f"boundaries, so flush slabs never straddle a page)")
            if prefill_chunk % self._align:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be a multiple of "
                    f"the policy flush window W={self._align} (chunked "
                    f"admission writes monolithic bytes only at W-aligned "
                    f"chunk boundaries)")
        if prefill_budget is not None and prefill_chunk is None:
            raise ValueError(
                "prefill_budget only bounds CHUNKED admission; pass "
                "prefill_chunk too")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {prefill_budget}")

    # ---------------------------------------------------------- mesh layout
    def _shard_cache_tree(self, cache: dict) -> dict:
        """A fresh cache laid out over the mesh: each attention state split
        by KV head over 'model' where divisible, else kept whole
        (``serve_cache_specs``).  Identity without a mesh."""
        return shard_cache(cache, self.mesh)

    def _replicate_tree(self, tree):
        """Every tensor on the mesh's lead device; identity without one."""
        return replicate_tree(tree, self.mesh)

    # ------------------------------------------------------- paged pool state
    def _pd(self):
        d = self.cache["attn"][0].data
        return getattr(d, "kv", d)

    def _sync_pool(self) -> None:
        """Refresh the host views of the allocator (a CPU copy: the pool
        lives on the host), track peak residency and prune prefix-index
        entries whose page was freed."""
        pd = self._pd()
        self._refcount_host = pd.pool.refcount.numpy().copy()
        self._ptab_host = pd.table_host.numpy().copy()
        used = int((self._refcount_host > 0).sum()) - 1  # null pinned
        self.peak_pages = max(self.peak_pages, used)
        for k in [k for k, p in self._prefix_pages.items()
                  if self._refcount_host[p] == 0]:
            del self._prefix_pages[k]
        for k in [k for k, (_, pgs) in self._prefix_seqs.items()
                  if (self._refcount_host[pgs] == 0).any()]:
            del self._prefix_seqs[k]

    def _pages_needed(self, prompt_len: int, max_new: int) -> int:
        # spec_k - 1 slack: a verify pass appends up to spec_k - 1 tokens
        # past the last position it can keep, and on an unmapped page they
        # would land in the null page, where the pass's own read misses
        # them
        return -(-(prompt_len + max_new + self._slack) // self.page_size)

    @property
    def _slack(self) -> int:
        return 0 if self.spec_k is None else self.spec_k - 1

    def _plan_pages(self, req: Request):
        """Host-side admission plan: walk the prefix index page by page
        (COW hits must be prefix-contiguous), then check the remainder
        against the free supply.  (shared_page_ids, n_new), or None when
        the pool cannot fit the request now."""
        prompt = np.asarray(req.prompt, np.int32)
        ps = self.page_size
        total = self._pages_needed(prompt.shape[-1], req.max_new_tokens)
        shared: list[int] = []
        for i in range(prompt.shape[-1] // ps):
            key = prompt[:(i + 1) * ps].tobytes()
            page = self._prefix_pages.get(key)
            if page is None or self._refcount_host[page] == 0 \
                    or not self._page_backed(page, i, key):
                break
            shared.append(page)
        n_new = total - len(shared)
        if n_new > int((self._refcount_host == 0).sum()):
            return None
        return shared, n_new

    def _page_backed(self, page: int, idx: int, key: bytes) -> bool:
        """True iff a live slot maps ``page`` at entry ``idx`` and its
        prompt spells the key's tokens: a stale index hit can then never
        alias a freed and reallocated page."""
        end = (idx + 1) * self.page_size
        for s in range(self.capacity):
            req = self._slot_req[s]
            if req is None or int(self._ptab_host[s, idx]) != page:
                continue
            p = np.asarray(req.prompt, np.int32)
            if p.shape[-1] >= end and p[:end].tobytes() == key:
                return True
        return False

    def _donor_live(self, toks: np.ndarray, pages: np.ndarray,
                    n_tokens: int) -> bool:
        """Token-level ``_page_backed``: a live slot maps exactly these
        pages for exactly these tokens."""
        npg = -(-n_tokens // self.page_size)
        for s in range(self.capacity):
            req = self._slot_req[s]
            if req is None or not np.array_equal(self._ptab_host[s, :npg],
                                                 pages[:npg]):
                continue
            p = np.asarray(req.prompt, np.int32)
            if p.shape[-1] >= n_tokens \
                    and np.array_equal(p[:n_tokens], toks[:n_tokens]):
                return True
        return False

    def _register_prefix(self, req: Request, slot: int) -> None:
        """Index this row's full prompt pages for later COW admissions, and
        its prompt (tokens and every page it touches, a partial tail page
        included) for token-level reuse.  Prompt bytes below the prompt's
        flush boundary are immutable: decode appends and int4 flushes land
        at or past the admission-time packed length."""
        prompt = np.asarray(req.prompt, np.int32)
        ps = self.page_size
        row = self._ptab_host[slot]
        for i in range(prompt.shape[-1] // ps):
            self._prefix_pages[prompt[:(i + 1) * ps].tobytes()] = int(row[i])
        n_pp = -(-prompt.shape[-1] // ps)
        self._prefix_seqs[prompt.tobytes()] = (prompt.copy(),
                                               row[:n_pp].copy())

    def _release_slots(self, slots) -> None:
        """Called before the reset that drops these slots' page references,
        while their bytes are resident: spill the registered prompt pages
        about to die into the host tier (when there is one), then prune
        every prefix-index entry whose page is about to be freed (a freed
        page may be reallocated with other content before the next sync
        could notice)."""
        if not self.paged:
            return
        drops = np.zeros((self.n_pages,), np.int32)
        for s in np.atleast_1d(np.asarray(slots, np.int64)):
            pages = self._ptab_host[int(s)]
            np.add.at(drops, pages[pages != NULL_PAGE], 1)
        rc = self._refcount_host
        dying = (rc > 0) & (rc - drops <= 0)
        dying[NULL_PAGE] = False
        if self.prefix_store is not None and dying.any():
            self._spill([(k, p) for k, p in self._prefix_pages.items()
                         if dying[p]])
        for k in [k for k, p in self._prefix_pages.items() if dying[p]]:
            del self._prefix_pages[k]
        for k in [k for k, (_, pgs) in self._prefix_seqs.items()
                  if dying[pgs].any()]:
            del self._prefix_seqs[k]

    def _spill(self, spill: list) -> None:
        """Put the dying pages ``spill`` ((key, page) in index order, that
        is page order) into the host tier: the keys not stored yet are
        exported, one ``export_pages`` a layer, and each page's payload
        is its leaves stacked with the layer axis leading; a stored key
        is only touched (its bytes are a function of its tokens)."""
        store = self.prefix_store
        fresh = [(k, p) for k, p in spill if k not in store]
        if fresh:
            per_layer = [st.policy.export_pages(st, [p for _, p in fresh])
                         for st in self.cache["attn"]]
            for j, (k, _) in enumerate(fresh):
                store.put(k, tuple(
                    torch.stack([leaves[i][j] for leaves in per_layer])
                    for i in range(len(per_layer[0]))))
            self.n_spilled_pages += len(fresh)
            self._trace.instant("offload.spill", cat="offload", tier="host",
                                pages=len(fresh))
        for k, _ in spill:
            store.touch(k)

    def _reset(self, mask: np.ndarray) -> None:
        """Retire the masked rows in every layer; their positions go to 0
        (in place, as every write between chunks)."""
        for st in self.cache["attn"]:
            st.policy.reset_rows(st, mask)
        pos = self.cache["pos"]
        pos.masked_fill_(torch.as_tensor(mask, device=pos.device), 0)
        if self.paged:
            self._sync_pool()

    def _preempt_one(self, protect_from_seq: int) -> bool:
        """Preempt the least recently admitted live slot to the front of
        the queue as a recompute continuation, freeing its pages.  Slots
        admitted in the current admission round (seq >= protect_from_seq)
        are never victims: that would make no progress; nor is the slot an
        in-flight chunked admission holds (it has no cache row yet).
        False when no slot is eligible."""
        pend = self._pending.slot if self._pending is not None else None
        live = [s for s in range(self.capacity)
                if self._slot_req[s] is not None
                and self._slot_seq[s] < protect_from_seq and s != pend]
        if not live:
            return False
        slot = min(live, key=lambda s: self._slot_seq[s])
        req = self._slot_req[slot]
        toks = self._slot_toks[slot]
        self._carried[req.rid] = self._carried.get(req.rid, []) + list(toks)
        # the prompt absorbs every token the cache has appended; the last
        # sampled one is not in the cache yet and resumes in the buffer
        gen = ([] if req.resume_tok is None else [req.resume_tok]) \
            + list(toks)
        self._queue.appendleft(Request(
            rid=req.rid,
            prompt=np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(gen[:-1], np.int32)]),
            max_new_tokens=req.max_new_tokens - len(toks),
            resume_tok=int(gen[-1]),
        ))
        self._slot_req[slot] = None
        self._slot_toks[slot] = []
        self.active[slot] = False
        self.budget[slot] = 0
        self._trace.instant(
            "engine.preempt", cat="sched", rid=req.rid, slot=int(slot),
            pages=int((self._ptab_host[slot] != NULL_PAGE).sum()),
            carried=len(self._carried[req.rid]))
        self._release_slots([slot])
        mask = np.zeros((self.capacity,), bool)
        mask[slot] = True
        self._reset(mask)
        self.n_preemptions += 1
        return True

    def pool_stats(self) -> Optional[dict]:
        """Pool utilization snapshot (None for dense engines): page
        counts, live per-request page spans, COW sharing and bytes (pool
        bytes from the policy's own ``nbytes``, summed over layers).
        Host data only, under the engine lock."""
        if not self.paged:
            return None
        with self.lock:
            return self._pool_stats_locked()

    def _pool_stats_locked(self) -> dict:
        rc = self._refcount_host
        used = int((rc > 0).sum()) - 1
        usable = self.n_pages - 1
        live = [s for s in range(self.capacity)
                if self._slot_req[s] is not None]
        mapped = int((self._ptab_host[live] != NULL_PAGE).sum()) if live \
            else 0
        pool_bytes = sum(st.nbytes() for st in self.cache["attn"])
        page_bytes = pool_bytes / self.n_pages
        # the host RAM the pool spends besides the device: the mirrors,
        # the prefix indexes and the host tier
        store = self.prefix_store
        host_bytes = {
            "refcount_mirror": int(rc.nbytes),
            "page_table_mirror": int(self._ptab_host.nbytes),
            "prefix_index": int(
                sum(len(k) for k in self._prefix_pages)
                + sum(len(k) + t.nbytes + pg.nbytes
                      for k, (t, pg) in self._prefix_seqs.items())),
            "offload_store": int(store.nbytes) if store is not None else 0,
        }
        host_bytes["total"] = sum(host_bytes.values())
        offload = {
            "enabled": store is not None,
            "spilled_pages": self.n_spilled_pages,
            "restored_pages": self.n_restored_pages,
            "restored_tokens": self.n_restored_tokens,
            "hits_device": self.n_reuse_hits_device,
            "hits_host": self.n_reuse_hits_host,
            "misses": self.n_reuse_misses,
        }
        if store is not None:
            offload["store"] = store.stats()
        return {
            "host_bytes": host_bytes,
            "offload": offload,
            "n_pages": usable,
            "page_size": self.page_size,
            "pages_used": used,
            "pages_free": usable - used,
            "utilization": used / max(usable, 1),
            "peak_pages": self.peak_pages,
            "live_requests": len(live),
            "pages_per_request": mapped / max(len(live), 1),
            "shared_pages": int((rc > 1).sum()),
            "preemptions": self.n_preemptions,
            "pool_bytes": int(pool_bytes),
            "used_page_bytes": int(used * page_bytes),
            "dense_equiv_bytes": int(
                page_bytes * self.max_pages * self.capacity),
        }

    # ----------------------------------------------------------- requests
    def _validate(self, req: Request) -> int:
        n = int(np.asarray(req.prompt).shape[-1])
        if n < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be >= 1")
        # a verify pass appends spec_k tokens before its rollback, and a
        # clamped out-of-range write would land on resident bytes
        slack = self._slack
        if n + req.max_new_tokens + slack > self.s_max:
            extra = f" + spec_k-1 ({slack})" if slack else ""
            raise ValueError(
                f"request {req.rid}: prompt ({n}) + max_new_tokens "
                f"({req.max_new_tokens}){extra} exceeds s_max={self.s_max}")
        return n

    def submit(self, req: Request) -> None:
        # paged: the s_max bound caps a request at max_pages pages, and the
        # constructor's floor lets the pool hold that once all else is
        # preempted
        with self.lock:
            self._validate(req)
            self._trace.req_mark(req.rid, "submit")
            self._queue.append(req)

    @property
    def pending(self) -> int:
        """Requests not yet decoding: queued, plus an in-flight chunked
        admission."""
        return len(self._queue) + (self._pending is not None)

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def n_free_slots(self) -> int:
        return sum(1 for r in self._slot_req if r is None)

    @property
    def has_work(self) -> bool:
        return self.pending > 0 or bool(self.active.any())

    def _notify(self, events, completions) -> None:
        """Fan (events, completions) out to ``step_listeners``, under the
        engine lock; listeners must be quick (enqueue and return) and must
        not call back into the engine."""
        if not events and not completions:
            return
        for fn in list(self.step_listeners):
            fn(events, completions)

    # ---------------------------------------------------------- admission
    def _admit(self, req: Request, slot: int, plan=None
               ) -> Optional[Completion]:
        """Prefill alone, copy into ``slot``, draw the first token.
        ``plan`` is the paged (shared_pages, n_new) admission plan."""
        tr, clock = self._trace, self._marks()
        tr.req_mark(req.rid, "submit")  # direct-admission callers
        tr.req_mark(req.rid, "admit")
        plen = int(np.asarray(req.prompt).shape[-1])
        t0p = time.perf_counter()
        start = clock.mark() if clock is not None else None
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None, :]
        row = self._shard_cache_tree(self.model.init_cache(
            1, self.s_max, policy=self.policy, rots=self._rots, ragged=True))
        logits, row = self.model.prefill(self.params, prompt, row)
        tok0 = self._draw_tok0(req, logits)
        self._insert_row(req, slot, row, tok0, plen, plan)
        if clock is not None:
            clock.push("prefill.device", start, clock.mark(),
                       charge=(req.rid,), rid=req.rid, tokens=plen)
        tr.span_at("engine.prefill", t0p, cat="prefill", rid=req.rid,
                   tokens=plen)
        return self._post_insert(req, slot, tok0)

    def _draw_tok0(self, req: Request, logits) -> torch.Tensor:
        """The admission token; a preemption resume re-enters its pending
        token and draws nothing."""
        if req.resume_tok is not None:
            return torch.full((1, 1), req.resume_tok, dtype=torch.long,
                              device=self.device)
        return self.sampler.sample(logits[:, -1], self.generator)[:, None]

    def _insert_row(self, req: Request, slot: int, row, tok0,
                    prompt_len: int, plan) -> None:
        """Copy a prefilled batch-1 row into ``slot``: a dense copy, or
        the paged COW insert plus its host bookkeeping."""
        if self.paged:
            shared, n_new = plan
            # monolithic and packed admissions take their tier here,
            # chunked ones in _start_pending
            if req.rid not in self._admit_tier:
                self._record_tier(req.rid, "device" if len(shared)
                                  else "miss")
                if len(shared):
                    self._trace.instant("prefix.adopt", cat="prefix",
                                        rid=req.rid, tier="device",
                                        pages=len(shared))
            for st, r in zip(self.cache["attn"], row["attn"]):
                st.policy.insert_row_paged(st, r, slot, shared, len(shared),
                                           n_new)
            self._slot_seq[slot] = self._admit_seq
            self._admit_seq += 1
            self._orig.setdefault(req.rid, (prompt_len, req.max_new_tokens))
            self._sync_pool()
            self._register_prefix(req, slot)
        else:
            self._record_tier(req.rid, "none")
            for st, r in zip(self.cache["attn"], row["attn"]):
                st.policy.insert_row(st, r, slot)
        self.cache["pos"][slot] = row["pos"][0]
        self.tok[slot] = tok0[0]

    def _reset_slot_now(self, slot: int) -> None:
        """Reset one slot at admission time (it may be re-admitted within
        the same quantum, so the reset cannot wait)."""
        self._release_slots([slot])
        mask = np.zeros((self.capacity,), bool)
        mask[slot] = True
        self._reset(mask)

    def _post_insert(self, req: Request, slot: int, tok0
                     ) -> Optional[Completion]:
        """The bookkeeping monolithic and chunked admission share, once
        the row is in its slot and ``tok0`` is drawn."""
        t0 = int(tok0[0, 0])
        self._resolve()
        self._slot_req[slot] = req
        self._trace.req_mark(req.rid, "first_token")
        if self.spec_k is not None:
            self._seed_hist(slot, req, t0)
        if req.resume_tok is not None:
            # t0 was already counted and streamed before the preemption
            self._slot_toks[slot] = []
            self.budget[slot] = req.max_new_tokens
            self.active[slot] = True
            return None
        self._slot_toks[slot] = [t0]
        self.budget[slot] = req.max_new_tokens - 1
        done = self.budget[slot] <= 0 or (
            self.eos_id is not None and t0 == self.eos_id)
        self.active[slot] = not done
        return self._retire(slot) if done else None

    def _seed_hist(self, slot: int, req: Request, t0: int) -> None:
        """(Re)seed a slot's drafter history: the prompt, then the
        admission token (a preemption continuation's prompt already holds
        everything generated before it, and ``t0`` is its resumed token);
        zeros past it.  In place, between chunks."""
        prompt = np.asarray(req.prompt, np.int64).ravel()
        row = np.zeros((self._hist.shape[1],), np.int64)
        row[:prompt.shape[0]] = prompt
        row[prompt.shape[0]] = t0
        self._hist[slot].copy_(torch.from_numpy(row))
        self._hlen[slot] = prompt.shape[0] + 1

    def _admit_monolithic(self, round_start: int, events: list,
                          completions: list) -> None:
        """Admit from the queue into free slots, one whole-prompt prefill
        each.  Paged: plan the head's pages and, when the pool is dry,
        preempt the LRU live slot and replan (its continuation lands at
        the head).  Victims predate this round, so the loop ends."""
        while self._queue:
            free = [s for s in range(self.capacity)
                    if self._slot_req[s] is None]
            if not free:
                break
            slot = free[0]
            plan = None
            if self.paged:
                plan = self._plan_pages(self._queue[0])
                if plan is None:
                    if not self._preempt_one(round_start):
                        break  # pages return at the end-of-step reset
                    continue
            req = self._queue.popleft()
            self._admitted(req, slot, self._admit(req, slot, plan), events,
                           completions)

    def _admitted(self, req: Request, slot: int, done, events: list,
                  completions: list) -> None:
        """Stream an admission's first token, or retire a request that
        finished at admission (eos / n=1)."""
        if done is not None:
            events.append((req.rid, [int(done.tokens[-1])]))
            completions.append(done)
            self._reset_slot_now(slot)
        elif req.resume_tok is None:  # resumes already streamed theirs
            events.append((req.rid, [self._slot_toks[slot][0]]))

    # -------------------------------------------------- packed admission
    def admit_packed(self, reqs: list[Request]) -> None:
        """Admit ``reqs`` through ONE batched prefill (ref
        ``batch_engine.py:1531-1633``).  Every prompt must have the same
        exact length: the batch is stacked, never padded (padding would
        change the prefill's sums and leave junk bytes in the cache).

        A packed row equals the same row of any other batch-k prefill of
        these prompts, in any row order, but not a batch-1 prefill's
        (cuBLAS rounds by row count), so streams are equal between runs
        that group admissions the same way.  Needs ``len(reqs)`` free
        slots (raises otherwise; callers pack against ``n_free_slots``)
        and monolithic admission.  Rows go to the free slots in order, and
        the first tokens are drawn in row order.  Paged, each row's pages
        are planned in order, preempting pre-round LRU victims as
        ``_admit_monolithic`` does; when the pool runs dry mid-group the
        unplaced tail is requeued at the front, in order (its prefill is
        repeated on re-admission)."""
        with self.lock:
            if not reqs:
                return
            if self.prefill_chunk is not None:
                raise ValueError(
                    "admit_packed requires monolithic admission "
                    "(prefill_chunk=None); chunked admission already "
                    "interleaves prefill with decode")
            lens = {self._validate(r) for r in reqs}
            if len(lens) != 1:
                raise ValueError(
                    f"admit_packed needs one exact prompt length, got "
                    f"{sorted(lens)} (stacked, never padded: padding would "
                    f"poison cache bytes)")
            free = [s for s in range(self.capacity)
                    if self._slot_req[s] is None]
            if len(reqs) > len(free):
                raise ValueError(
                    f"admit_packed: {len(reqs)} requests but only "
                    f"{len(free)} free slots (callers pack against "
                    f"n_free_slots)")
            self._admit_packed_locked(reqs, free[:len(reqs)])

    def _admit_packed_locked(self, reqs: list[Request],
                             slots: list[int]) -> None:
        k, tr, clock = len(reqs), self._trace, self._marks()
        for req in reqs:
            tr.req_mark(req.rid, "submit")  # direct callers (no submit())
            tr.req_mark(req.rid, "admit")
        prompts = torch.as_tensor(
            np.stack([np.asarray(r.prompt, np.int64) for r in reqs]),
            device=self.device)
        L = int(prompts.shape[-1])
        t0p = time.perf_counter()
        start = clock.mark() if clock is not None else None
        staged = self._shard_cache_tree(self.model.init_cache(
            k, self.s_max, policy=self.policy, rots=self._rots, ragged=True))
        logits, staged = self.model.prefill(self.params, prompts, staged)
        rids = [r.rid for r in reqs]
        if clock is not None:
            # the group shares one prefill: each request waited on all of it
            clock.push("prefill.device", start, clock.mark(), charge=rids,
                       rids=rids, rows=k, tokens=L)
        tr.span_at("prefill.packed", t0p, cat="prefill", rows=k, tokens=L,
                   rids=rids)
        events: list[tuple[int, list[int]]] = []
        completions: list[Completion] = []
        round_start = self._admit_seq if self.paged else 0
        for j, (req, slot) in enumerate(zip(reqs, slots)):
            plan = None
            if self.paged:
                while (plan := self._plan_pages(req)) is None:
                    if not self._preempt_one(round_start):
                        self._queue.extendleft(reversed(reqs[j:]))
                        self._notify(events, completions)
                        return
            tok0 = self._draw_tok0(req, logits[j:j + 1])
            self._insert_row(req, slot, self._slice_row(staged, j), tok0, L,
                             plan)
            self._admitted(req, slot, self._post_insert(req, slot, tok0),
                           events, completions)
        self._notify(events, completions)

    def _row_slice_axes(self) -> tuple:
        """The batch axis of each staging-cache leaf of one layer state
        (``_leaves`` order), None where the leaf has none (the rotations):
        found by comparing the shapes of batch-1 and batch-2 states, built
        once on the CPU at one flush window of tokens, so no head count or
        capacity that equals the group size can confuse it."""
        if self._slice_axes is None:
            cfg = self.model.cfg

            def shapes(b):
                st = self.policy.init_state(b, cfg.n_kv_heads, self._align,
                                            cfg.head_dim, device="cpu",
                                            ragged=True)
                return [t.shape for t in _leaves(st)]

            axes = []
            for s1, s2 in zip(shapes(1), shapes(2)):
                diff = [i for i, (a, b) in enumerate(zip(s1, s2)) if a != b]
                if len(diff) > 1 or (diff and s1[diff[0]] != 1):
                    raise AssertionError(
                        f"cannot locate the batch axis of a staging-cache "
                        f"leaf: {tuple(s1)} vs {tuple(s2)}")
                axes.append(diff[0] if diff else None)
            self._slice_axes = tuple(axes)
        return self._slice_axes

    def _slice_row(self, staged: dict, j: int) -> dict:
        """Batch-1 view of row ``j`` of a batch-k staging cache, shaped as
        a monolithic admission's staging row (the ``_insert_row`` input)."""
        axes = self._row_slice_axes()

        def row(st):
            if isinstance(st, ShardedState):
                return st.map_shards(row)
            views = (t if ax is None else t.narrow(ax, j, 1)
                     for t, ax in zip(_leaves(st), axes))
            return _rebuild(st, views)

        return {"pos": staged["pos"].narrow(0, j, 1),
                "attn": [row(st) for st in staged["attn"]]}

    # ------------------------------------------------- chunked admission
    def _find_donor(self, prompt: np.ndarray
                    ) -> tuple[int, Optional[np.ndarray]]:
        """The longest token-level prefix ``prompt`` shares with a resident
        prompt, aligned down to W and capped at ``len(prompt) - 1`` (the
        last token is computed: its logits draw the first token).  Then
        every shared token lies below the donor's flush boundary, where
        its bytes are resident and immutable.  (n_shared, donor pages), or
        (0, None) below one page."""
        best_t, best_pages = 0, None
        cap = int(prompt.shape[-1]) - 1
        for toks, pages in self._prefix_seqs.values():
            n = min(int(toks.shape[-1]), cap)
            if n <= best_t:
                continue
            neq = np.nonzero(toks[:n] != prompt[:n])[0]
            t = int(neq[0]) if neq.size else n
            t = (t // self._align) * self._align
            if t > best_t and t >= self.page_size \
                    and self._donor_live(toks, pages, t):
                best_t, best_pages = t, pages
        if best_t < self.page_size:
            return 0, None
        return best_t, best_pages

    def _find_host_prefix(self, prompt: np.ndarray
                          ) -> tuple[int, Optional[list]]:
        """The deepest run of ``prompt``'s page keys in the host tier,
        walked from the first page and stopped at the first miss; at most
        ``(len(prompt) - 1) // page_size`` pages (the last token is
        computed).  (n_tokens, page payloads in page order), or (0, None)."""
        if self.prefix_store is None:
            return 0, None
        ps = self.page_size
        payloads: list[tuple] = []
        for i in range((int(prompt.shape[-1]) - 1) // ps):
            pl = self.prefix_store.get(prompt[:(i + 1) * ps].tobytes())
            if pl is None:
                break
            payloads.append(pl)
        if not payloads:
            return 0, None
        return len(payloads) * ps, payloads

    def _restore(self, row: dict, payloads: list, n_tok: int) -> None:
        """Seed the staging row from host page payloads: each leaf's pages
        stacked (n_layers, NP, H, ps, c), copied to the card at once, and
        imported into every layer; its length and position set."""
        stacked = [torch.stack([pl[j] for pl in payloads], dim=1).to(
            self.device) for j in range(len(payloads[0]))]
        for i, r in enumerate(row["attn"]):
            r.policy.import_pages(r, tuple(leaf[i] for leaf in stacked),
                                  n_tok)
        row["pos"].fill_(n_tok)

    def _seed(self, row: dict, pages: np.ndarray, n_tok: int) -> None:
        """Adopt the donor pages' bytes into the staging row, every layer,
        and set its length and position to ``n_tok``."""
        for r, st in zip(row["attn"], self.cache["attn"]):
            r.policy.adopt_prefix(r, st, pages, n_tok)
        row["pos"].fill_(n_tok)

    def _raw_view(self, row: dict, n_shared: int, raw_k: torch.Tensor,
                  raw_v: torch.Tensor) -> None:
        """Fill positions [0, n_shared) of the raw side buffers from the
        seeded row: bf16 reads back its bytes, int4 dequantizes and
        inverse-rotates (B4), so the prompt's suffix attends the prefix
        every decode step reads."""
        for i, st in enumerate(row["attn"]):
            k, v = st.policy.raw_kv_view(st, n_shared)
            raw_k[i, :, :, :n_shared] = k.to(raw_k.dtype)
            raw_v[i, :, :, :n_shared] = v.to(raw_v.dtype)

    def _start_pending(self, req: Request, slot: int) -> None:
        """Open a chunked admission: the staging row and raw buffers, the
        slot reserved and, paged with reuse, the row seeded from a donor
        so that chunking starts after the shared tokens.  A preemption
        continuation never reuses: its recompute must rebuild the bytes
        its first admission wrote."""
        tr = self._trace
        tr.req_mark(req.rid, "admit")
        prompt = np.asarray(req.prompt, np.int32)
        n_total = int(prompt.shape[-1])
        row = self._shard_cache_tree(self.model.init_cache(
            1, self.s_max, policy=self.policy, rots=self._rots, ragged=True))
        shared_t = 0
        if self.paged and self.prefix_reuse and req.resume_tok is None:
            # the deeper tier wins; a device hit wins a tie (no copy)
            shared_t, donor_pages = self._find_donor(prompt)
            host_t, payloads = self._find_host_prefix(prompt)
            if host_t > shared_t:
                self._restore(row, payloads, host_t)
                shared_t = host_t
                self.n_restored_pages += len(payloads)
                self.n_restored_tokens += host_t
                self.n_reuse_hits_host += 1
                self._record_tier(req.rid, "host")
                tr.instant("prefix.restore", cat="prefix", rid=req.rid,
                           tier="host", pages=len(payloads), tokens=host_t)
            elif shared_t:
                npg = -(-shared_t // self.page_size)
                self._seed(row, donor_pages[:npg], shared_t)
                self.n_reuse_hits_device += 1
                self._record_tier(req.rid, "device")
                tr.instant("prefix.adopt", cat="prefix", rid=req.rid,
                           tier="device", pages=npg, tokens=shared_t)
            else:
                self.n_reuse_misses += 1
                self._record_tier(req.rid, "miss")
                tr.instant("prefix.miss", cat="prefix", rid=req.rid)
        cfg = self.model.cfg
        shape = (cfg.n_layers, 1, cfg.n_kv_heads, n_total, cfg.head_dim)
        raw_k = torch.zeros(shape, dtype=torch.bfloat16, device=self.device)
        raw_v = torch.zeros_like(raw_k)
        if shared_t:
            self._raw_view(row, shared_t, raw_k, raw_v)
        self._slot_req[slot] = req  # reserved; inactive until the insert
        self._pending = _PendingAdmission(
            req=req, slot=slot, row=row, raw_k=raw_k, raw_v=raw_v,
            n_done=shared_t, n_total=n_total, reused_tokens=shared_t)
        self.n_reused_tokens += shared_t

    def _finalize_pending(self, round_start: int, events: list,
                          completions: list) -> bool:
        """Insert a fully prefilled pending admission into its slot.  False
        when the paged pool cannot fit it yet and no slot can be
        preempted: it stays pending until retirements return pages."""
        pend = self._pending
        req, slot = pend.req, pend.slot
        plan = None
        if self.paged:
            while (plan := self._plan_pages(req)) is None:
                if not self._preempt_one(round_start):
                    return False
        # drawn once the insert is certain: a retry draws nothing
        tok0 = self._draw_tok0(req, pend.logits)
        self._insert_row(req, slot, pend.row, tok0, pend.n_total, plan)
        self._pending = None  # the staging buffers go here
        self._admitted(req, slot, self._post_insert(req, slot, tok0), events,
                       completions)
        return True

    def _admit_chunked(self, round_start: int, events: list,
                       completions: list) -> None:
        """Spend at most ``prefill_budget`` prompt tokens (at least one
        chunk) on the in-flight admission, opening one from the queue head
        when none is; a finished one is inserted and, budget left, the
        next one begins in the same quantum.  Reused tokens cost no
        budget.  One admission is in flight at a time (FIFO)."""
        spent, clock = 0, self._marks()
        while True:
            if self._pending is None:
                free = [s for s in range(self.capacity)
                        if self._slot_req[s] is None]
                if not self._queue or not free:
                    return
                self._start_pending(self._queue.popleft(), free[0])
            pend = self._pending
            prompt = np.asarray(pend.req.prompt, np.int64)
            while pend.n_done < pend.n_total and (
                    spent == 0 or spent < self.prefill_budget):
                C = min(self.prefill_chunk, pend.n_total - pend.n_done)
                t0c = time.perf_counter()
                start = clock.mark() if clock is not None else None
                toks = torch.as_tensor(
                    prompt[None, pend.n_done:pend.n_done + C],
                    device=self.device)
                pend.logits, pend.row, pend.raw_k, pend.raw_v = \
                    self.model.prefill_chunk(self.params, toks, pend.row,
                                             pend.raw_k, pend.raw_v)
                pend.n_done += C
                spent += C
                self.n_prefill_chunks += 1
                if clock is not None:
                    clock.push("prefill.device", start, clock.mark(),
                               charge=(pend.req.rid,), rid=pend.req.rid,
                               tokens=C, done=pend.n_done)
                self._trace.span_at("prefill.chunk", t0c, cat="prefill",
                                    rid=pend.req.rid, tokens=C,
                                    done=pend.n_done, total=pend.n_total)
            if pend.n_done < pend.n_total:
                return  # budget spent: decode now
            if not self._finalize_pending(round_start, events, completions):
                return  # pool dry: retried after this quantum's retirements
            if spent >= self.prefill_budget:
                return

    # ---------------------------------------------------------- retirement
    def _retire(self, slot: int, reason: Optional[str] = None) -> Completion:
        req = self._slot_req[slot]
        toks = self._slot_toks[slot]
        max_new = req.max_new_tokens
        plen = int(np.asarray(req.prompt).shape[-1])
        if self.paged:
            # stitch tokens carried across preemptions back on, reported
            # against the original prompt and budget
            toks = self._carried.pop(req.rid, []) + toks
            plen, max_new = self._orig.pop(req.rid, (plen, max_new))
        toks = np.asarray(toks, np.int32)
        if reason is None:
            reason = ("eos" if self.eos_id is not None and len(toks)
                      and toks[-1] == self.eos_id and len(toks) < max_new
                      else "length")
        self._slot_req[slot] = None
        self._slot_toks[slot] = []
        self.active[slot] = False
        self.budget[slot] = 0
        self._count_outcome(req.rid, reason)
        self._trace.req_done(req.rid)
        self._trace.instant("req.retire", cat="request", rid=req.rid,
                            reason=reason, tokens=int(len(toks)))
        return Completion(rid=req.rid, prompt_len=plen, tokens=toks,
                          finish_reason=reason)

    def _cancelled(self, req: Request) -> Completion:
        """A queued request (or continuation) cancelled: everything it
        streamed lives in ``_carried``."""
        plen = int(np.asarray(req.prompt).shape[-1])
        toks: list[int] = []
        if self.paged:
            toks = self._carried.pop(req.rid, [])
            plen, _ = self._orig.pop(req.rid, (plen, req.max_new_tokens))
        self._count_outcome(req.rid, "cancelled")
        self._trace.req_done(req.rid)
        return Completion(rid=req.rid, prompt_len=plen,
                          tokens=np.asarray(toks, np.int32),
                          finish_reason="cancelled")

    def cancel_all(self) -> list[Completion]:
        """Cancel every live, pending and queued request, returning partial
        ``Completion``s.  Afterwards every slot is free, every length zero
        and, paged, every refcount zero but the null page's.  Listeners
        see the cancellations as one final batch."""
        with self.lock:
            completions = []
            if self._pending is not None:
                pend, self._pending = self._pending, None
                self._slot_req[pend.slot] = None  # the reservation
                completions.append(self._cancelled(pend.req))
            completions += [self._retire(s, reason="cancelled")
                            for s in range(self.capacity)
                            if self._slot_req[s] is not None]
            while self._queue:
                completions.append(self._cancelled(self._queue.popleft()))
            self.active[:] = False
            self.budget[:] = 0
            self._release_slots(list(range(self.capacity)))
            self._reset(np.ones((self.capacity,), bool))
            self._notify([], completions)
            return completions

    # -------------------------------------------------------------- decode
    def _step(self) -> None:
        """One decode step of the whole batch on the fixed buffers (the
        body the graph captures): rows live when the token was drawn
        spend one step of budget and stay live while budget is left and
        the token is not ``eos_id``."""
        active, budget = self._active, self._budget
        logits, _ = self.model.decode_step(
            self.params, self.tok, self.cache, kv_block=self.kv_block,
            backend=self.backend, active=active)
        nxt = self.sampler.sample(logits[:, -1], self.generator)
        budget.sub_(active.to(budget.dtype))
        alive = active & (budget > 0)
        if self.eos_id is not None:
            alive &= nxt != self.eos_id
        self.tok.copy_(nxt[:, None])
        active.copy_(alive)

    def _spec_step(self):
        """One speculative pass of the whole batch on the fixed buffers
        (ref ``_spec_chunk_fn``'s body, ``batch_engine.py:994-1043``; the
        body the graph captures): ``engine.verify_pass`` with the live
        mask, the budgets and ``eos_id``; rows that are not live keep
        their token.  Returns the verified tokens (cap, k) and which of
        them are emitted."""
        k = self.spec_k
        active, budget = self._active, self._budget
        g, m, self._snaps = verify_pass(
            self.model, self.params, self.cache, self.tok, self._hist,
            self._hlen, budget, k, snaps=self._snaps, active=active,
            eos_id=self.eos_id, kv_block=self.kv_block, backend=self.backend)
        valid = torch.arange(k, device=g.device)[None, :] < m[:, None]
        nxt = g.gather(1, (m - 1).clamp(0, k - 1)[:, None])
        nxt = torch.where(active[:, None], nxt, self.tok)
        budget.sub_(m.to(budget.dtype))
        alive = active & (budget > 0)
        if self.eos_id is not None:
            alive &= nxt[:, 0] != self.eos_id
        self._spec_counts.add_(torch.stack([
            active.long().sum() * (k - 1),
            torch.where(active, m - 1, 0).sum()]))
        self.tok.copy_(nxt)
        active.copy_(alive)
        return g, valid

    def _stepper(self):
        """The step to run: eager, or the captured graph's replay (the
        first call captures it); a speculative step returns its (tokens,
        valid) pair.  A speculative capture also puts back the residual
        rings and the drafter's buffers after its warm-up pass: a pass
        that keeps tokens past a flush boundary wraps the ring over slots
        that are live again once the lengths are put back."""
        spec = self.spec_k is not None
        body = self._spec_step if spec else self._step
        if not self.graph:
            return body
        if self._step_graph is None:
            state = [self.tok, self._active, self._budget, self.cache["pos"],
                     *(st.length for st in self.cache["attn"]),
                     *step_lengths(self.cache)]
            if spec:
                state += [self._hist, self._hlen, self._spec_counts,
                          *(t for st in self.cache["attn"]
                            for t in st.policy.rollback_leaves(st))]
            self._step_graph = StepGraph(
                body, state, generator=self.generator
                if self.sampler.temperature else None)
        graph = self._step_graph

        def replay():
            graph.replay()
            return graph.out

        return replay

    def _decode_chunk(self, n_steps: int):
        """``n_steps`` decode steps (speculative passes) of the whole
        batch; the host's masks go into the device buffers first, and one
        readback ends the chunk.  Returns host (tokens (cap, n), valid
        (cap, n), budget (cap,), still-active (cap,)), n = n_steps, or
        n_steps x spec_k with the pass counters added to ``n_drafted`` /
        ``n_accepted``.  Traced: the ``decode.device`` span runs from just
        before the masks' copies to the last device write, before the
        readback."""
        tr, clock = self._trace, self._marks()
        with tr.span("decode.upload", cat="host"):
            active = torch.from_numpy(self.active)
            budget = torch.from_numpy(self.budget)
            # the start event right before the first copy, so that little
            # host time lies between it and the chunk's first device work
            start = clock.mark() if clock is not None else None
            self._active.copy_(active)
            self._budget.copy_(budget)
        step = self._stepper()
        k = self.spec_k
        with tr.span("decode.enqueue", cat="host"):
            if k is None:
                for i in range(n_steps):
                    self._valid[:, i].copy_(self._active)
                    step()
                    self._toks[:, i].copy_(self.tok[:, 0])
                n, extra = n_steps, []
            else:
                self._spec_counts.zero_()
                for i in range(n_steps):
                    g, valid = step()
                    self._toks[:, i * k:(i + 1) * k].copy_(g)
                    self._valid[:, i * k:(i + 1) * k].copy_(valid)
                n = n_steps * k
                extra = [self._spec_counts[None, :].expand(self.capacity, 2)]
        with tr.span("decode.readback", cat="host"):
            host = torch.cat([self._toks[:, :n], self._valid[:, :n].long(),
                              self._budget[:, None].long(),
                              self._active[:, None].long(), *extra], 1)
            if clock is not None:
                clock.push("decode.device", start, clock.mark(), gap=True,
                           steps=n_steps)
            host = host.cpu().numpy()
        self._resolve()
        if k is not None:
            self.n_drafted += int(host[0, 2 * n + 2])
            self.n_accepted += int(host[0, 2 * n + 3])
        return (host[:, :n], host[:, n:2 * n].astype(bool),
                host[:, 2 * n].astype(np.int32), host[:, 2 * n + 1] != 0)

    def step(self) -> tuple[list[tuple[int, list[int]]], list[Completion]]:
        """One scheduler quantum: admit into free slots, decode one chunk.
        Returns (events, completions); ``events`` holds one ``(rid,
        new_tokens)`` per live request.  ``step_listeners`` receive the
        same pair before it is returned, under the engine lock."""
        with self.lock:
            t0 = time.perf_counter()
            events, completions = self._step_locked()
            self._notify(events, completions)
            self._trace.span_at("engine.step", t0, cat="engine",
                                streams=len(events),
                                retired=len(completions))
            return events, completions

    def _step_locked(self):
        events: list[tuple[int, list[int]]] = []
        completions: list[Completion] = []
        round_start = self._admit_seq if self.paged else 0
        tr = self._trace
        with tr.span("step.admit", cat="host"):
            if self.prefill_chunk is not None:
                self._admit_chunked(round_start, events, completions)
            else:
                self._admit_monolithic(round_start, events, completions)
        if not self.active.any():  # admission retires were reset in-loop
            return events, completions

        # the chunk is clipped to the longest remaining budget
        n_steps = int(min(self.chunk, self.budget[self.active].max()))
        t0d = time.perf_counter()
        n_live = int(self.active.sum())
        drafted, accepted = (self.n_drafted, self.n_accepted) \
            if self.spec_k is not None else (0, 0)
        toks, valid, budget, still_active = self._decode_chunk(n_steps)
        tr.span_at("decode.chunk", t0d, cat="decode", steps=n_steps,
                   rows=n_live, spec=self.spec_k is not None)
        if self.spec_k is not None:
            nd, na = self.n_drafted - drafted, self.n_accepted - accepted
            tr.instant("spec.verify", cat="spec", drafted=nd, accepted=na,
                       rejected=nd - na)
        with tr.span("step.scatter", cat="host"):
            self.budget = budget.copy()
            newly_retired = np.zeros((self.capacity,), bool)
            for slot in range(self.capacity):
                req = self._slot_req[slot]
                if req is None or not self.active[slot]:
                    continue
                new = [int(t) for t, ok in zip(toks[slot], valid[slot]) if ok]
                self._slot_toks[slot].extend(new)
                events.append((req.rid, new))
                if not still_active[slot]:
                    completions.append(self._retire(slot))
                    newly_retired[slot] = True
            self.active = still_active.copy()
            if newly_retired.any():  # lengths back to zero, pages released
                self._release_slots(np.nonzero(newly_retired)[0])
                self._reset(newly_retired)
        return events, completions

    def run(self, requests: Optional[list[Request]] = None
            ) -> Iterator[Completion]:
        """Drain the queue (plus ``requests``), yielding completions as
        they finish."""
        for r in requests or ():
            self.submit(r)
        while self.has_work:
            _, completions = self.step()
            yield from completions
