"""Single-stream generation engine (port of ``repro/launch/engine.py``:
``Sampler``, ``Engine.prefill`` / ``decode`` / ``generate`` and the
module-level ``generate``).

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

``Engine(graph=False)``, and every CPU model, runs the eager loop: the
same step, one Python call after another, on either kind of cache.  It
is the oracle the graph is held against, as the reference's per-step
loop is for its scan.  Sampling draws from an explicit
``torch.Generator``; greedy decoding never syncs with the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.cache_api import AttendBackend
from repro_torch.launch.graphs import StepGraph

__all__ = ["Sampler", "GREEDY", "Engine", "generate"]

GRAPH_KEY = "decode_graph"  # where a cache keeps its captured step


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


class Engine:
    """Generation for one (model, backend, sampler) configuration.
    ``graph`` (default: on a CUDA model) decodes through a captured CUDA
    graph; ``graph=False`` runs the eager loop.  A CPU model has only the
    eager loop and refuses ``graph=True``."""

    def __init__(self, model, *, backend: "AttendBackend | str | None" = None,
                 sampler: Optional[Sampler] = None, kv_block: int = 512,
                 graph: Optional[bool] = None):
        on_card = model.device.type == "cuda"
        if graph and not on_card:
            raise ValueError(f"graph=True needs a CUDA model (got "
                             f"{model.device}); the CPU runs the eager loop")
        self.model = model
        self.backend = None if backend is None else AttendBackend.parse(backend)
        self.sampler = sampler if sampler is not None else GREEDY
        self.kv_block = kv_block
        self.graph = on_card if graph is None else graph
        self._pool = None  # the memory pool the engine's graphs share

    def prefill(self, params, prompt: torch.Tensor, cache: dict):
        """Returns (last-token logits (B, 1, V), cache filled in place)."""
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

    def _decode_graph(self, params, tok, cache, n_tokens, generator,
                      return_logits):
        if not isinstance(cache["pos"], torch.Tensor):
            raise ValueError(
                "graph decode replays device lengths: build the cache with "
                "model.init_cache(batch, s_max, ragged=True), or decode "
                "with Engine(graph=False)")
        if self.sampler.temperature and generator is None:
            raise ValueError("sampling under a graph needs an explicit "
                             "torch.Generator on the card (generator=)")
        # the room check comes first: the capture's warm-up step writes
        # at the length, and a full cache's ragged write would clamp onto
        # its last token
        held = cache.get(GRAPH_KEY)
        length = (held.length if held is not None and held.length is not None
                  else int(cache["pos"].max()))
        s_max = cache["attn"][0].s_max
        if length + n_tokens > s_max:
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
        view = {"pos": cache["pos"], "attn": cache["attn"]}

        def step():
            logits, _ = model.decode_step(params, s_tok, view,
                                          kv_block=kv_block, backend=backend)
            last = logits[:, -1]
            s_tok.copy_(sampler.sample(last, generator)[:, None])
            return last

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        state = [s_tok, cache["pos"], *(st.length for st in cache["attn"])]
        graph = StepGraph(step, state, pool=self._pool,
                          generator=generator if sampler.temperature
                          else None)
        cap = _Captured(key, (self, params, generator), graph, s_tok,
                        graph.out)
        cache[GRAPH_KEY] = cap
        return cap

    def generate(self, params, prompt: torch.Tensor, cache: dict,
                 n_tokens: int, *, generator: Optional[torch.Generator] = None,
                 return_logits: bool = False):
        """Prefill + sample + (n_tokens - 1) decode steps.  The first token
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
