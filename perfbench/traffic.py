"""The one traffic generator: turns a traffic file (``traffic/<name>.json``)
and a seed into requests.

Every seed gets the same sizes and the same arrival gaps, in another
order, so that seeds change the tokens and the order of the work but not
its amount.  Sizes and gaps are drawn by stratified quantiles: a block of
``block`` consecutive requests holds the ``block`` quantile midpoints of
each distribution, shuffled by the seed, so any stretch of the schedule
sees nearly the same mix.

- ``closed``: ``sessions`` requests, all submitted at once; ``max_new``
  is ``"fill"`` (each request runs to ``s_max``) or a distribution.
- ``open``: an open loop at ``rate`` requests a second (exponential gaps
  by quantile, i.e. a stratified Poisson process); each request has its
  due time in seconds from the start of the arrival clock.

Prompt tokens are uniform over the vocabulary, drawn from the seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

__all__ = ["RequestSpec", "quantiles", "make_requests", "horizon_requests"]


@dataclasses.dataclass
class RequestSpec:
    rid: int
    prompt: np.ndarray  # (P,) int64 token ids
    max_new: int
    due: Optional[float]  # seconds after the arrival clock starts; None: closed


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n quantile midpoints of a length distribution, ascending ints."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["lo"]), float(dist["hi"])
    kind = dist.get("dist", "log_uniform")
    if kind == "log_uniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif kind == "fixed":
        x = np.full(n, lo)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    r = int(dist.get("round", 1))
    out = np.maximum(np.round(x / r) * r, r).astype(np.int64)
    return np.clip(out, r * math.ceil(lo / r), hi).astype(np.int64)


def _blocked(values_of_block, n: int, block: int, rng) -> np.ndarray:
    """n values: each block of ``block`` is the block's quantiles in an
    order drawn from ``rng``."""
    out = []
    while len(out) < n:
        out.extend(rng.permutation(values_of_block))
    return np.asarray(out[:n])


def horizon_requests(traffic: dict, seconds: float) -> int:
    """How many open-loop requests cover warm-up, window and drain."""
    t = traffic["warmup_s"] + seconds + traffic["drain_s"]
    return int(math.ceil(traffic["rate"] * t)) + traffic.get("block", 16)


def make_requests(traffic: dict, vocab: int, seed: int, *,
                  s_max: int, seconds: float = 0.0) -> list[RequestSpec]:
    # one stream each for lengths, outputs, gaps and tokens, so the first
    # requests are the same whatever the horizon
    rng_p, rng_o, rng_g, rng_t = (np.random.default_rng(s) for s in
                                  np.random.SeedSequence(seed).spawn(4))
    if traffic["kind"] == "closed":
        n = int(traffic["sessions"])
        plens = rng_p.permutation(quantiles(traffic["prompt"], n))
        if traffic["max_new"] == "fill":
            news = s_max - plens
        else:
            news = rng_o.permutation(quantiles(traffic["max_new"], n))
        dues = [None] * n
    elif traffic["kind"] == "open":
        block = int(traffic.get("block", 16))
        n = horizon_requests(traffic, seconds)
        plens = _blocked(quantiles(traffic["prompt"], block), n, block, rng_p)
        news = _blocked(quantiles(traffic["output"], block), n, block, rng_o)
        u = (np.arange(block) + 0.5) / block
        gaps = -np.log1p(-u) / float(traffic["rate"])
        dues = np.cumsum(_blocked(gaps, n, block, rng_g)).tolist()
    else:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    out = []
    for i in range(n):
        p, m = int(plens[i]), int(news[i])
        if p + m > s_max:
            raise ValueError(f"request {i}: {p} + {m} tokens > s_max {s_max}")
        prompt = rng_t.integers(0, vocab, size=p, dtype=np.int64)
        out.append(RequestSpec(i, prompt, m, dues[i]))
    return out
