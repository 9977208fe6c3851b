"""Seeded request-trace generation (port of
``repro/launch/server/trace.py`` over ``repro_torch.data``: the same
arguments give the reference's prompts, as int32, and arrival times).

One workload generator shared by the serving CLI (``launch/serve.py``)
and ``chip_smoke.py``'s serve phase, so both replay IDENTICAL token
streams: same seed, same mixed prompt-length buckets, same prompt
bytes.

``align`` rounds each bucket length UP to the policy flush window W /
page size, reusing the §11 alignment invariants: aligned buckets mean
requests land on a handful of EXACT lengths, which is what lets the
bucketed admission stage (server/admission.py) stack them into one
batched prefill -- packing stacks, it never pads (padding
would change the flash-prefill reduction order and poison cache bytes).

Arrival processes are seeded too (numpy
Generator): ``closed`` (everything at t=0 -- the parity tests' shape),
``poisson`` (exponential inter-arrivals at ``rate`` req/s) and
``bursty`` (groups of ``burst`` requests every ``burst_gap_s``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.launch.batch_engine import Request

__all__ = ["TraceItem", "bucket_lengths", "make_requests", "make_trace"]


@dataclasses.dataclass(frozen=True)
class TraceItem:
    """One load-trace entry: a request plus its arrival offset."""

    req: Request
    arrival_s: float


def bucket_lengths(prompt_len: int, *, align: int = 1) -> list[int]:
    """The CLI's historical mixed-length buckets -- L, L/2 and 3L/4 --
    each aligned UP to ``align`` and deduplicated.  ``align=1`` is
    byte-identical to the lengths serve.py used to build inline."""
    a = max(int(align), 1)
    raw = {prompt_len, max(prompt_len // 2, 1), max(3 * prompt_len // 4, 1)}
    return sorted({n + (-n) % a for n in raw})


def make_requests(n: int, *, prompt_len: int, new_tokens: int,
                  seed: int = 0, align: int = 1,
                  run_len: int = 1) -> list[Request]:
    """The closed-loop request queue: ``n`` requests over the synthetic
    corpus, prompt lengths walking the buckets in runs of ``run_len``
    (``run_len=1`` cycles one-by-one -- byte-identical to the queue
    serve.py used to build inline; larger runs put same-length arrivals
    back to back, which is what the bucketed admission stage can stack
    into one packed prefill dispatch).  Deterministic in every
    argument -- two callers with the same arguments replay identical
    prompts."""
    if run_len < 1:
        raise ValueError(f"run_len must be >= 1, got {run_len}")
    buckets = bucket_lengths(prompt_len, align=align)
    it = DataIterator(SyntheticCorpus(seed + 1), batch_per_shard=max(n, 1),
                      seq_len=buckets[-1], device="cpu")
    toks = it.next()["tokens"].numpy().astype(np.int32)
    return [
        Request(
            rid=i,
            prompt=np.asarray(toks[i % toks.shape[0],
                                   :buckets[(i // run_len) % len(buckets)]]),
            max_new_tokens=new_tokens,
        )
        for i in range(n)
    ]


def make_trace(n: int, *, prompt_len: int, new_tokens: int, seed: int = 0,
               align: int = 1, run_len: int = 1, arrival: str = "poisson",
               rate: float = 8.0, burst: int = 4,
               burst_gap_s: float = 0.25) -> list[TraceItem]:
    """``make_requests`` plus a seeded arrival process.  Arrival times
    are offsets from the replay start; requests are listed in arrival
    order (the admission stage's grouping input)."""
    reqs = make_requests(n, prompt_len=prompt_len, new_tokens=new_tokens,
                         seed=seed, align=align, run_len=run_len)
    if arrival == "closed":
        times = np.zeros((n,))
    elif arrival == "poisson":
        rng = np.random.default_rng(seed + 0xA11)
        times = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), size=n))
    elif arrival == "bursty":
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        times = np.repeat(
            np.arange(-(-n // burst)) * burst_gap_s, burst
        )[:n]
    else:
        raise ValueError(
            f"unknown arrival process {arrival!r} "
            f"(closed | poisson | bursty)"
        )
    return [TraceItem(req=r, arrival_s=float(t))
            for r, t in zip(reqs, times)]
