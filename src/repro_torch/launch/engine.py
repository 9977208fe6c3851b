"""Single-stream generation engine (port of ``repro/launch/engine.py``:
``Sampler``, ``Engine.prefill`` / ``decode`` / ``generate`` and the
module-level ``generate``).

The reference runs the decode loop as one donated ``lax.scan``; here it
is a Python loop over a preallocated cache that every step updates in
place (so the cache passed in is the cache returned).  Sampling draws
from an explicit ``torch.Generator``.  Greedy decoding never syncs with
the device: the sampled token feeds the next step on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.cache_api import AttendBackend

__all__ = ["Sampler", "GREEDY", "Engine", "generate"]


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


class Engine:
    """Generation for one (model, backend, sampler) configuration."""

    def __init__(self, model, *, backend: "AttendBackend | str | None" = None,
                 sampler: Optional[Sampler] = None, kv_block: int = 512):
        self.model = model
        self.backend = None if backend is None else AttendBackend.parse(backend)
        self.sampler = sampler if sampler is not None else GREEDY
        self.kv_block = kv_block

    def prefill(self, params, prompt: torch.Tensor, cache: dict):
        """Returns (last-token logits (B, 1, V), cache filled in place)."""
        return self.model.prefill(params, prompt, cache)

    def decode(self, params, tok: torch.Tensor, cache: dict, n_tokens: int, *,
               generator: Optional[torch.Generator] = None,
               return_logits: bool = False):
        """``n_tokens`` decode steps from ``tok`` (B, 1), the last sampled
        token (not yet in the cache).  Returns (tokens (B, n_tokens),
        cache), or (tokens, logits (B, n_tokens, V) fp32, cache) with
        ``return_logits``."""
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
             kv_block: int = 512):
    """Prefill + decode through a one-off :class:`Engine`; returns
    (tokens (B, n_tokens), cache)."""
    eng = Engine(model, backend=backend, sampler=sampler, kv_block=kv_block)
    return eng.generate(params, prompt, cache, n_tokens, generator=generator)
