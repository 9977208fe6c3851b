"""The end-to-end arithmetic, taken over every sample of the window.

A *delivery* is what one ``BatchEngine.step`` hands one stream: the time
the step returned (host clock, after the step's device readback) and the
number of tokens.  A stream's first delivery carries its first token.
"""
from __future__ import annotations

from typing import Iterable, Optional

__all__ = ["percentile", "output_tok_s", "tpot_samples", "ttft_samples"]


def percentile(values: Iterable[float], p: float) -> Optional[float]:
    """The p-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    k = (len(xs) - 1) * p / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def output_tok_s(deliveries: dict, t_open: float, t_close: float) -> float:
    """Tokens delivered in (t_open, t_close] over the window's seconds;
    ``deliveries`` maps a stream to its [(time, n_tokens), ...]."""
    n = sum(k for ds in deliveries.values() for t, k in ds
            if t_open < t <= t_close)
    return n / (t_close - t_open)


def tpot_samples(deliveries: dict, t_open: float, t_close: float
                 ) -> list[float]:
    """Seconds per token of every delivery in the window that is not its
    stream's first: the gap since the stream's previous delivery over the
    tokens it carries."""
    out = []
    for ds in deliveries.values():
        for (t_prev, _), (t, k) in zip(ds, ds[1:]):
            if t_open < t <= t_close and k > 0:
                out.append((t - t_prev) / k)
    return out


def ttft_samples(due: dict, first: dict, t_open: float, t_close: float
                 ) -> tuple[list[float], int]:
    """For each request due in (t_open, t_close]: its first delivery's time
    less its due time.  Returns (samples, requests due in the window
    with no first token)."""
    out, missing = [], 0
    for rid, t_due in due.items():
        if t_due is None or not t_open < t_due <= t_close:
            continue
        if rid in first:
            out.append(first[rid] - t_due)
        else:
            missing += 1
    return out, missing
