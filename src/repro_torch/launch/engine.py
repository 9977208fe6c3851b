"""Single-stream generation engine (port of ``repro/launch/engine.py``:
``Sampler``, ``draft_tokens`` (:129), ``Engine.prefill`` / ``decode`` /
``generate``, the speculative ``_check_spec`` / ``decode_spec`` /
``generate_spec`` (:325-460) and the module-level ``generate``).

The reference runs the decode loop as one donated ``lax.scan``
(``_decode_loop``, :261).  Here, on a CUDA model, ``decode`` captures
one decode step (embed, every block with its cache write and read,
unembed, the sampler) in a CUDA graph (``launch/graphs.py``) and replays
it ``n_tokens`` times: no host sync and one launch per token.  The graph
replays fixed addresses, so the cache must carry its lengths on the
device: the single stream runs on a ragged cache,
``model.init_cache(batch, s_max, ragged=True)``; a plain cache (a Python
int length, branched on by the host) raises.  The graph lives in the
cache (``cache["decode_graph"]``) and is freed with it.

Every family takes this path.  The recurrent ones (hybrid, ssm) and the
encoder-decoder (audio) accept ``ragged=True`` with every row at one
length, so their caches keep ``pos`` and their KV lengths on the device,
and their recurrent states (SSM, conv, mLSTM, sLSTM) and the read-only
cross-attention cache sit at fixed addresses that each step updates in
place; the capture's warm-up step puts back everything a step advances
(``model.step_state``).  An audio prompt is the tuple ``(frames,
tokens)`` (ref ``engine.py:36-39``), for a cache built with
``init_cache(batch, s_max_dec, s_enc)``.

``Engine(graph=False)``, and every CPU model, runs the eager loop: the
same step, one Python call after another, on either kind of cache.  It
is the oracle the graph is held against, as the reference's per-step
loop is for its scan.  Sampling draws from an explicit
``torch.Generator``; greedy decoding never syncs with the device.

``Engine(mesh=)`` (ref ``engine.py:69-94``, ``:184-240``): ``shard_params``
keeps the params on the mesh's lead device (replicated: every projection
runs once there, at full width) and ``shard_cache`` splits each attention
state by KV head over the 'model' axis (``launch/sharded_cache.py``), so
only the cache writes and the attend run per shard and the tokens and
cache bytes equal the unsharded engine's.  A KERNEL read runs B1 or B2
on each shard's heads (the reference, whose Pallas read GSPMD cannot
partition, falls back to BLOCKWISE there with a warning).
``shard_cache(cache, allow_split_k=True)`` splits a dense state whose
KV heads do not divide the axis by position instead (split-K): the
cache bytes still equal the unsharded engine's, and each read combines
the shards' parts by their log-sum-exps (B1 per shard on a KERNEL
read), so logits agree within float rounding and greedy streams up to a
near-tie.  Speculative decoding serves such a cache too: each verify
query runs the split decode read at its own length (with GATHER's
numerics, as the unsplit verify), and the rollback rewinds every shard,
so ``generate_spec`` on a split cache returns ``generate``'s tokens on
it (bit for bit under GATHER) and leaves the same bytes.
When every shard lies on one card the step is captured and replayed as
without a mesh; a mesh whose shards lie on more than one card runs the
eager loop, since nothing here can test a capture across cards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ATTENTION_FAMILIES
from repro_torch.core.cache_api import AttendBackend
from repro_torch.launch.graphs import StepGraph
from repro_torch.launch.partitioning import replicate_tree
from repro_torch.launch.sharded_cache import shard_cache, step_lengths

__all__ = ["Sampler", "GREEDY", "Engine", "generate", "draft_tokens",
           "verify_pass", "mesh_allows_graph"]

GRAPH_KEY = "decode_graph"  # where a cache keeps its captured step
SPEC_KEY = "spec_graph"  # where a cache keeps its captured verify pass


def mesh_allows_graph(mesh, graph: Optional[bool]) -> bool:
    """False for a mesh whose shards lie on more than one card (it steps
    eagerly: a capture across cards is untested); ``graph=True`` there
    raises."""
    if mesh is None or len(mesh.cards) <= 1:
        return True
    if graph:
        raise ValueError(
            f"graph=True on a mesh over {len(mesh.cards)} cards: the "
            f"captured step is held on one card only; use graph=False")
    return False


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Token-selection rule: temperature 0 is greedy argmax; top_k > 0
    restricts sampling to the k highest logits."""

    temperature: float = 0.0
    top_k: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    def sample(self, logits: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """logits (B, V) -> tokens (B,) int64."""
        if self.temperature == 0.0:
            return logits.argmax(dim=-1)
        scaled = logits.float() / self.temperature
        if self.top_k:
            kth = torch.topk(scaled, self.top_k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, -torch.inf, scaled)
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]


GREEDY = Sampler()


def draft_tokens(hist: torch.Tensor, hlen, k: int) -> torch.Tensor:
    """n-gram / prompt-lookup drafter (ref ``engine.py:129``): propose k - 1
    continuation tokens from each row's own history.  ``hist`` (B, H)
    holds the prompt and every token sampled since, ``hist[:, hlen - 1]``
    the current one; ``hlen`` is a shared int or 0-d tensor, or per-row
    (B,).  The most recent earlier position whose (previous, current)
    bigram matches the tail wins, a unigram match otherwise, and the
    tokens that followed it are proposed; with no match, the current
    token repeated.  Device ops only, no host sync; drafts only gate how
    many verified tokens are kept, never what they are.  Returns (B,
    k - 1) int64.  A shared length reads as every row at it: the
    reference's scalar path clamps its slices as the per-row gathers
    clip their indices, so the two agree row by row."""
    B, H = hist.shape
    dev = hist.device
    pos = torch.arange(H, device=dev)[None, :]
    hl = torch.as_tensor(hlen, device=dev).long().reshape(-1, 1).expand(B, 1)
    t = hist.gather(1, (hl - 1).clamp(0, H - 1))
    prev = hist.gather(1, (hl - 2).clamp(0, H - 1))
    m1 = (pos < hl - 1) & (hist == t)  # a match with a successor in hist
    shifted = torch.cat([hist[:, :1], hist[:, :-1]], dim=1)
    m2 = m1 & (pos >= 1) & (shifted == prev)
    p1 = torch.where(m1, pos, -1).amax(dim=1)  # the most recent match
    p2 = torch.where(m2, pos, -1).amax(dim=1)
    pstar = torch.where(p2 >= 0, p2, p1)  # a bigram beats a unigram
    j = torch.arange(1, k, device=dev)[None, :]
    drafts = hist.gather(1, (pstar[:, None] + j).clamp(0, H - 1))
    return torch.where(pstar[:, None] >= 0, drafts, t)


def verify_pass(model, params, cache: dict, tok: torch.Tensor,
                hist: torch.Tensor, hlen: torch.Tensor, budget: torch.Tensor,
                k: int, *, snaps=None, active=None, eos_id=None,
                kv_block: int = 512, backend=None):
    """One draft-verify-accept-rollback pass, greedy (ref ``engine.py:
    354-384`` and ``batch_engine.py:994-1043``): each row drafts k - 1
    tokens from its history, ``LM.decode_verify`` scores the k-token
    block (``tok`` first), and the row keeps m = the longest draft prefix
    the verified greedy tokens confirm + 1, clamped to its ``budget``,
    cut after an ``eos_id``, and 0 where not ``active`` (such a row
    appended at its length without advancing, and the rollback to L0 + 0
    restores it).  The cache rolls back to L0 + m, every row to its own
    length, and the kept tokens extend the history where active; all in
    place.  On a plain cache m is read to the host (its length is a host
    int).  Returns (g (B, k) the verified tokens, m (B,), snaps)."""
    pos = cache["pos"]
    ragged = isinstance(pos, torch.Tensor)
    L0 = pos.clone() if ragged else pos
    block = torch.cat([tok, draft_tokens(hist, hlen, k)], dim=1)
    logits, _, snaps = model.decode_verify(
        params, block, cache, kv_block=kv_block, backend=backend,
        active=active, snaps=snaps)
    g = logits.argmax(dim=-1)
    match = (block[:, 1:] == g[:, :-1]).long()
    m = torch.minimum(match.cumprod(dim=1).sum(dim=1) + 1, budget.long())
    if eos_id is not None:
        # tokens past an EOS were never sampled in the sequential run
        is_eos = g == eos_id
        m = torch.where(is_eos.any(dim=1),
                        torch.minimum(m, is_eos.long().argmax(dim=1) + 1), m)
    if active is not None:
        m = torch.where(active, m, 0)
    model.truncate_cache(cache, L0 + m if ragged else L0 + int(m), snaps)
    idx = hlen.clamp(max=hist.shape[1] - k)[:, None] + torch.arange(
        k, device=g.device)[None, :]
    hist.scatter_(1, idx, g if active is None else
                  torch.where(active[:, None], g, hist.gather(1, idx)))
    hlen.add_(m)
    return g, m, snaps


@dataclasses.dataclass
class _SpecBuffers:
    """The fixed buffers one speculative pass reads and writes: the last
    token (1, 1), the drafter's history (1, H) and its length, the tokens
    still to emit, the drafted and accepted counters (all (1,) int64),
    and the per-layer snapshots (None until the first pass)."""

    tok: torch.Tensor
    hist: torch.Tensor
    hlen: torch.Tensor
    budget: torch.Tensor
    drafted: torch.Tensor
    accepted: torch.Tensor
    snaps: Optional[list] = None

    @classmethod
    def new(cls, H: int, device) -> "_SpecBuffers":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.long, device=device)

        return cls(z(1, 1), z(1, H), z(1), z(1), z(1), z(1))

    def seed(self, prompt: torch.Tensor, tok: torch.Tensor,
             n_tokens: int) -> None:
        """History = prompt + tok (zeros past it), budget ``n_tokens``,
        counters zero; in place."""
        S = prompt.shape[1]
        self.hist.zero_()
        self.hist[:, :S] = prompt
        self.hist[:, S:S + 1] = tok
        self.hlen.fill_(S + 1)
        self.tok.copy_(tok)
        self.budget.fill_(n_tokens)
        self.drafted.zero_()
        self.accepted.zero_()

    def leaves(self) -> list:
        return [self.tok, self.hist, self.hlen, self.budget, self.drafted,
                self.accepted]


@dataclasses.dataclass
class _SpecCaptured:
    """A cache's captured speculative pass and the buffers it replays."""

    key: tuple
    refs: tuple
    step: StepGraph
    buf: _SpecBuffers


@dataclasses.dataclass
class _Captured:
    """A cache's captured decode step: the static token buffer it reads
    and writes, its logits, the references its addresses belong to, and
    the host's copy of the cache length (None when unknown)."""

    key: tuple
    refs: tuple
    step: StepGraph
    tok: torch.Tensor
    logits: torch.Tensor
    length: Optional[int] = None


def _s_max(cache: dict) -> Optional[int]:
    """The room of the cache a decode step appends to (``attn``, or an
    encoder-decoder's ``self``); None for a model without a KV cache."""
    states = cache.get("attn") or cache.get("self")
    return states[0].s_max if states else None


def _view(cache: dict) -> dict:
    """The cache without the graphs it holds."""
    return {k: v for k, v in cache.items() if k not in (GRAPH_KEY, SPEC_KEY)}


class Engine:
    """Generation for one (model, backend, sampler) configuration.
    ``graph`` (default: on a CUDA model) decodes through a captured CUDA
    graph; ``graph=False`` runs the eager loop.  A CPU model has only the
    eager loop and refuses ``graph=True``.  ``mesh`` serves a cache laid
    out by :meth:`shard_cache` (see the module docstring)."""

    def __init__(self, model, *, backend: "AttendBackend | str | None" = None,
                 sampler: Optional[Sampler] = None, kv_block: int = 512,
                 graph: Optional[bool] = None, mesh=None):
        on_card = model.device.type == "cuda"
        if graph and not on_card:
            raise ValueError(f"graph=True needs a CUDA model (got "
                             f"{model.device}); the CPU runs the eager loop")
        on_card = on_card and mesh_allows_graph(mesh, graph)
        self.model = model
        self.mesh = mesh
        self.backend = None if backend is None else AttendBackend.parse(backend)
        self.sampler = sampler if sampler is not None else GREEDY
        self.kv_block = kv_block
        self.graph = on_card if graph is None else graph
        self._pool = None  # the memory pool the engine's graphs share

    def shard_params(self, params):
        """Params for the mesh: kept on its lead device (replicated; every
        projection runs once there at full width).  Identity without a
        mesh."""
        return replicate_tree(params, self.mesh)

    def shard_cache(self, cache: dict, *, allow_split_k: bool = False):
        """``cache`` laid out over the mesh: each attention state split by
        KV head over 'model' where divisible, else with ``allow_split_k``
        by position where that divides (a dense state), else kept whole
        (``partitioning.serve_cache_specs``).  Identity without a mesh."""
        return shard_cache(cache, self.mesh, allow_split_k=allow_split_k)

    def prefill(self, params, prompt, cache: dict):
        """Returns (last-token logits (B, 1, V), cache filled in place).
        ``prompt`` is tokens (B, S), or ``(frames, tokens)`` for the audio
        family."""
        if isinstance(prompt, tuple):
            out = self.model.prefill(params, *prompt, cache)
            prompt = prompt[-1]
        else:
            out = self.model.prefill(params, prompt, cache)
        if GRAPH_KEY in cache:
            cache[GRAPH_KEY].length = prompt.shape[1]
        return out

    def decode(self, params, tok: torch.Tensor, cache: dict, n_tokens: int, *,
               generator: Optional[torch.Generator] = None,
               return_logits: bool = False):
        """``n_tokens`` decode steps from ``tok`` (B, 1), the last sampled
        token (not yet in the cache).  Returns (tokens (B, n_tokens),
        cache), or (tokens, logits (B, n_tokens, V) fp32, cache) with
        ``return_logits``.

        Under a graph, the first call on a cache captures the step.  The
        room for ``n_tokens`` is checked on the host before that and
        before the first replay (a ragged write clamps, so an overrun
        would not raise later).  The check reads the host's copy of the length, which
        ``prefill`` and every graph decode keep; when it is unknown (the
        cache was filled or stepped outside this path) it is read from
        the device once."""
        if self.graph:
            return self._decode_graph(params, tok, cache, n_tokens,
                                      generator, return_logits)
        if GRAPH_KEY in cache:
            cache[GRAPH_KEY].length = None
        step = self.model.decode_body(params, kv_block=self.kv_block,
                                      backend=self.backend)
        toks, logits_out = [], []
        for _ in range(n_tokens):
            cache, logits = step(cache, tok)
            if return_logits:
                logits_out.append(logits[:, -1].float())
            tok = self.sampler.sample(logits[:, -1], generator)[:, None]
            toks.append(tok)
        B = tok.shape[0]
        out = (torch.cat(toks, dim=1) if toks
               else torch.zeros((B, 0), dtype=torch.long, device=tok.device))
        if return_logits:
            stacked = torch.stack(logits_out, dim=1) if logits_out else None
            return out, stacked, cache
        return out, cache

    @staticmethod
    def _require_ragged(cache: dict) -> None:
        if not isinstance(cache["pos"], torch.Tensor):
            raise ValueError(
                "graph decode replays device lengths: build the cache with "
                "model.init_cache(batch, s_max, ragged=True), or decode "
                "with Engine(graph=False)")

    @staticmethod
    def _host_length(cache: dict) -> int:
        """The cache's length on the host: a plain cache's int, or the
        copy ``prefill`` and the graph paths keep, else one readback."""
        pos = cache["pos"]
        if isinstance(pos, int):
            return pos
        held = cache.get(GRAPH_KEY)
        if held is not None and held.length is not None:
            return held.length
        return int(pos.max())

    def _decode_graph(self, params, tok, cache, n_tokens, generator,
                      return_logits):
        self._require_ragged(cache)
        if self.sampler.temperature and generator is None:
            raise ValueError("sampling under a graph needs an explicit "
                             "torch.Generator on the card (generator=)")
        # the room check comes first: the capture's warm-up step writes
        # at the length, and a full cache's ragged write would clamp onto
        # its last token
        length = self._host_length(cache)
        s_max = _s_max(cache)
        if s_max is not None and length + n_tokens > s_max:
            raise ValueError(f"cache full: {length} + {n_tokens} tokens > "
                             f"s_max={s_max}")
        B = tok.shape[0]
        toks = torch.empty((B, n_tokens), dtype=torch.long, device=tok.device)
        if not n_tokens:
            return (toks, None, cache) if return_logits else (toks, cache)
        cap = self._captured(params, tok, cache, generator)
        logits = (torch.empty((B, n_tokens, cap.logits.shape[-1]),
                              dtype=torch.float32, device=tok.device)
                  if return_logits else None)
        cap.tok.copy_(tok)
        for i in range(n_tokens):
            cap.step.replay()
            toks[:, i].copy_(cap.tok[:, 0])
            if logits is not None:
                logits[:, i].copy_(cap.logits)
        cap.length = length + n_tokens
        return (toks, logits, cache) if return_logits else (toks, cache)

    def _captured(self, params, tok, cache, generator) -> _Captured:
        """The cache's captured step for these params, token shape and
        generator: the one kept in the cache, or a new capture."""
        key = (id(self), id(params), tuple(tok.shape), id(generator))
        cap = cache.get(GRAPH_KEY)
        if cap is not None and cap.key == key:
            return cap
        model, sampler, kv_block = self.model, self.sampler, self.kv_block
        backend = self.backend
        s_tok = tok.clone()
        # the step sees the cache's buffers, not the dict that will hold
        # the graph (no reference cycle: the graph dies with the cache)
        view = _view(cache)

        def step():
            logits, _ = model.decode_step(params, s_tok, view,
                                          kv_block=kv_block, backend=backend)
            last = logits[:, -1]
            s_tok.copy_(sampler.sample(last, generator)[:, None])
            return last

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        state = [s_tok, *model.step_state(cache), *step_lengths(cache)]
        graph = StepGraph(step, state, pool=self._pool,
                          generator=generator if sampler.temperature
                          else None)
        cap = _Captured(key, (self, params, generator), graph, s_tok,
                        graph.out)
        cache[GRAPH_KEY] = cap
        return cap

    def generate(self, params, prompt, cache: dict,
                 n_tokens: int, *, generator: Optional[torch.Generator] = None,
                 return_logits: bool = False):
        """Prefill + sample + (n_tokens - 1) decode steps (``prompt`` as
        :meth:`prefill` takes it).  The first token
        comes from the prefill logits; the last sampled token is returned
        but not appended to the cache.  Returns (tokens (B, n_tokens),
        cache), or (tokens, logits, cache) with ``return_logits``, where
        ``logits[:, i]`` are the logits token i was drawn from."""
        logits, cache = self.prefill(params, prompt, cache)
        tok0 = self.sampler.sample(logits[:, -1], generator)[:, None]
        rest = self.decode(params, tok0, cache, n_tokens - 1,
                           generator=generator, return_logits=return_logits)
        toks = torch.cat([tok0, rest[0]], dim=1)
        if not return_logits:
            return toks, rest[1]
        steps = [logits[:, -1:].float()]
        if rest[1] is not None:
            steps.append(rest[1])
        return toks, torch.cat(steps, dim=1), rest[2]


    # ----------------------------------------------- speculative decoding
    def _check_spec(self, cache: dict, spec_k: int, batch: int) -> None:
        """The reference's validation (``engine.py:325-352``), made before
        any prefill.  The recurrent and audio families have no verify
        pass (recurrent state cannot roll back), as the reference's."""
        family = self.model.cfg.family
        if family not in ATTENTION_FAMILIES:
            raise NotImplementedError(
                f"speculative verify needs a pure-attention family (got "
                f"{family}: recurrent state has no per-row lengths and no "
                f"rollback)")
        if self.sampler.temperature != 0.0:
            raise ValueError(
                "speculative decoding requires greedy sampling "
                "(temperature == 0): exact-match acceptance against the "
                "verify argmax is what keeps output bit-identical")
        if spec_k < 2:
            raise ValueError(f"spec_k must be >= 2, got {spec_k}")
        if batch != 1:
            raise ValueError(
                "Engine.decode_spec serves a single stream (batch 1): a "
                "non-ragged cache has one shared length, so per-row "
                "acceptance widths are impossible -- use BatchEngine "
                "with spec_k for batched speculative decoding")
        W = getattr(cache["attn"][0].policy, "window", None)
        if W is not None and spec_k > W:
            raise ValueError(
                f"spec_k={spec_k} must be <= the policy flush window "
                f"W={W}: a verify pass appends at most one residual-ring "
                f"wrap (DESIGN.md §13)")

    def _check_spec_room(self, cache: dict, length: int, n_tokens: int,
                         spec_k: int) -> None:
        s_max = cache["attn"][0].s_max
        if length + n_tokens + spec_k - 1 > s_max:
            raise ValueError(
                f"cache full: {length} + {n_tokens} tokens + spec_k-1 "
                f"({spec_k - 1}) > s_max={s_max}: a verify pass appends "
                f"k tokens before its rollback")

    def _spec_pass(self, params, cache: dict, buf: _SpecBuffers,
                   k: int) -> None:
        """One :func:`verify_pass` on ``buf``.  On a ragged cache a spent
        budget makes the row inactive, so the pass is a no-op by data
        (m = 0, ``tok`` kept: the index m - 1 is clipped); on a plain
        cache the caller never runs a spent pass."""
        ragged = isinstance(cache["pos"], torch.Tensor)
        g, m, buf.snaps = verify_pass(
            self.model, params, cache, buf.tok, buf.hist, buf.hlen,
            buf.budget, k, snaps=buf.snaps,
            active=buf.budget > 0 if ragged else None,
            kv_block=self.kv_block, backend=self.backend)
        nxt = g.gather(1, (m - 1).clamp(min=0)[:, None])
        buf.tok.copy_(torch.where(m[:, None] > 0, nxt, buf.tok))
        buf.budget.sub_(m)
        buf.drafted.add_((m > 0).long() * (k - 1))
        buf.accepted.add_((m - 1).clamp(min=0))

    def decode_spec(self, params, tok: torch.Tensor, cache: dict,
                    n_tokens: int, *, prompt: torch.Tensor, spec_k: int):
        """Self-speculative decode of ``n_tokens`` tokens from ``tok`` (1,
        1), the last sampled token (not yet in the cache); ``prompt`` (1,
        S) seeds the drafter.  Greedy only.  Returns (tokens (1,
        n_tokens), cache, stats) with ``tokens`` equal to
        :meth:`decode`'s and ``stats`` ``{"drafted", "accepted"}``: draft
        positions scored and kept, the always-emitted token excluded
        (the reference's), and ``"passes"``, the verify passes run.  The
        cache needs spec_k - 1 tokens of room past the last decoded
        position (a verify pass appends before it rolls back).  Under a
        graph the first call on a cache captures the pass."""
        self._check_spec(cache, spec_k, tok.shape[0])
        length = self._host_length(cache)
        self._check_spec_room(cache, length, n_tokens, spec_k)
        S = prompt.shape[1]
        if S + n_tokens > cache["attn"][0].s_max:
            raise ValueError(f"the drafter's history holds s_max tokens: "
                             f"prompt {S} + {n_tokens} new is more")
        ragged = isinstance(cache["pos"], torch.Tensor)
        if self.graph:
            self._require_ragged(cache)
        if not n_tokens:
            return (torch.zeros((1, 0), dtype=torch.long, device=tok.device),
                    cache, {"drafted": 0, "accepted": 0, "passes": 0})
        prompt = prompt.to(tok.device).long()
        if self.graph:
            cap = self._spec_captured(params, cache, spec_k, prompt, tok,
                                      n_tokens)
            buf, step = cap.buf, cap.step.replay
        else:
            buf = _SpecBuffers.new(cache["attn"][0].s_max + spec_k,
                                   tok.device)
            buf.seed(prompt, tok, n_tokens)

            def step():
                self._spec_pass(params, cache, buf, spec_k)
        remaining, passes = n_tokens, 0
        while remaining:
            n_pass = math.ceil(remaining / spec_k) if ragged else 1
            for _ in range(n_pass):
                step()
            passes += n_pass
            remaining = int(buf.budget)
        nd, na = torch.cat([buf.drafted, buf.accepted]).tolist()
        out = buf.hist[:, S + 1:S + 1 + n_tokens].clone()
        if GRAPH_KEY in cache:
            cache[GRAPH_KEY].length = length + n_tokens
        return out, cache, {"drafted": nd, "accepted": na, "passes": passes}

    def _spec_captured(self, params, cache, spec_k, prompt, tok, n_tokens
                       ) -> _SpecCaptured:
        """The cache's captured pass for these params and spec_k (the one
        kept in the cache, or a new capture), its buffers seeded.  The
        capture's warm-up pass is undone by putting back every tensor a
        pass advances, the residual rings included: a warm-up that
        accepts past a flush boundary wraps the ring over slots that are
        live again once the length is put back.  A sharded state's
        ``rollback_leaves`` are every shard's, so shards 1..'s lengths and
        ring copies are put back as well."""
        key = (id(self), id(params), spec_k)
        cap = cache.get(SPEC_KEY)
        if cap is not None and cap.key == key:
            cap.buf.seed(prompt, tok, n_tokens)
            return cap
        buf = _SpecBuffers.new(cache["attn"][0].s_max + spec_k, tok.device)
        buf.seed(prompt, tok, n_tokens)
        buf.snaps = [st.policy.snapshot_rows(st) for st in cache["attn"]]
        view = {"pos": cache["pos"], "attn": cache["attn"]}
        model_pass = self._spec_pass

        def step():
            model_pass(params, view, buf, spec_k)

        state = [*buf.leaves(), cache["pos"],
                 *(t for st in cache["attn"]
                   for t in st.policy.rollback_leaves(st))]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cap = _SpecCaptured(key, (self, params),
                            StepGraph(step, state, pool=self._pool), buf)
        cache[SPEC_KEY] = cap
        return cap

    def generate_spec(self, params, prompt: torch.Tensor, cache: dict,
                      n_tokens: int, *, spec_k: int):
        """Prefill + speculative decode, equal to :meth:`generate`'s greedy
        tokens: the first from the prefill logits, the other n_tokens - 1
        from :meth:`decode_spec`.  Validated before the prefill touches
        the cache.  Returns (tokens (1, n_tokens), cache, stats)."""
        self._check_spec(cache, spec_k, prompt.shape[0])
        self._check_spec_room(cache, prompt.shape[1], n_tokens - 1, spec_k)
        logits, cache = self.prefill(params, prompt, cache)
        tok0 = logits[:, -1].argmax(dim=-1)[:, None]
        if n_tokens == 1:
            return tok0, cache, {"drafted": 0, "accepted": 0, "passes": 0}
        toks, cache, stats = self.decode_spec(
            params, tok0, cache, n_tokens - 1, prompt=prompt, spec_k=spec_k)
        return torch.cat([tok0, toks], dim=1), cache, stats


def generate(params, prompt: torch.Tensor, cache: dict, n_tokens: int, *,
             model, backend: "AttendBackend | str | None" = None,
             sampler: Optional[Sampler] = None,
             generator: Optional[torch.Generator] = None,
             kv_block: int = 512, graph: Optional[bool] = None):
    """Prefill + decode through a one-off :class:`Engine`; returns
    (tokens (B, n_tokens), cache)."""
    eng = Engine(model, backend=backend, sampler=sampler, kv_block=kv_block,
                 graph=graph)
    return eng.generate(params, prompt, cache, n_tokens, generator=generator)
