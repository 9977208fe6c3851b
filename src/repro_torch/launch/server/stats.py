"""Serving observability: histograms, counters, machine-readable cache
reports (port of ``repro/launch/server/stats.py``: ``Histogram``,
``ServerMetrics`` and the Prometheus text are the reference's stdlib and
numpy code, copied; ``cache_report_data`` reads the port's per-layer
cache states).

``ServerMetrics`` is the one mutable stats object both serving paths
update -- the threaded pipeline and the single-threaded reference loop
record TTFT/ITL through the SAME code, so a comparison of the two
measures pipelining, never measurement plumbing.  ``cache_report_data``
is the machine-readable twin of serve.py's ``_cache_report`` printout
(``--stats-json``): tests and ``chip_smoke.py`` assert on its dict
instead of parsing stdout.
"""
from __future__ import annotations

import random
import re
import threading
from typing import Optional

import numpy as np

__all__ = ["Histogram", "ServerMetrics", "cache_report_data",
           "sanitize_metric_name"]

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def sanitize_metric_name(name: str) -> str:
    """Coerce a caller-supplied gauge name into the Prometheus metric
    name charset ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (strict scrapers reject
    anything else).  Invalid characters map to ``_``."""
    if _NAME_OK.match(name):
        return name
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not name or not re.match(r"[a-zA-Z_:]", name[0]):
        name = "_" + name
    return name


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


class Histogram:
    """Latency accumulator: record seconds, summarize percentiles.

    Bounded: up to ``cap`` samples are kept verbatim (exact quantiles --
    a test or a ``chip_smoke.py`` run fits under the default cap), beyond
    that the kept set becomes a uniform reservoir (Vitter's Algorithm R, a
    deterministic RNG so two identical runs summarize identically) and
    quantiles are estimates over it.  ``count``/``sum``/``max``/``mean``
    stay exact at any scale -- a long-running ``serve.py --http`` no
    longer grows its metrics without bound."""

    def __init__(self, cap: int = 4096):
        if cap <= 0:
            raise ValueError(f"Histogram cap must be positive, got {cap}")
        self._v: list[float] = []
        self._cap = cap
        self._rng = random.Random(0)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def record(self, x: float) -> None:
        x = float(x)
        self._count += 1
        self._sum += x
        self._max = x if self._count == 1 else max(self._max, x)
        if len(self._v) < self._cap:
            self._v.append(x)
        else:
            j = self._rng.randrange(self._count)
            if j < self._cap:
                self._v[j] = x

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def summary(self) -> dict:
        if not self._v:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0,
                    "max": 0.0, "sum": 0.0}
        v = np.asarray(self._v)
        return {
            "count": self._count,
            "mean": self._sum / self._count,
            "p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99)),
            "max": self._max,
            "sum": self._sum,
        }


class ServerMetrics:
    """Counters + latency histograms for one serving run.  All methods
    take the internal lock: the detokenize thread records while HTTP
    handler threads scrape ``/metrics``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.received = 0
        self.rejected = 0
        self.completed = 0
        self.cancelled = 0
        self.tokens_streamed = 0
        self.ttft = Histogram()   # arrival -> first streamed token
        self.itl = Histogram()    # per-token inter-token latency
        self.e2e = Histogram()    # arrival -> completion

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "requests_received": self.received,
                "requests_rejected": self.rejected,
                "requests_completed": self.completed,
                "requests_cancelled": self.cancelled,
                "tokens_streamed": self.tokens_streamed,
                "ttft_s": self.ttft.summary(),
                "itl_s": self.itl.summary(),
                "e2e_s": self.e2e.summary(),
            }

    _COUNTER_HELP = {
        "requests_received": "Requests accepted at intake",
        "requests_rejected": "Requests bounced with 429 backpressure",
        "requests_completed": "Requests finished (eos or length)",
        "requests_cancelled": "Requests cancelled before completion",
        "tokens_streamed": "Tokens pushed to client streams",
    }
    _SUMMARY_HELP = {
        "ttft": "Arrival to first streamed token, seconds",
        "itl": "Inter-token latency, seconds",
        "e2e": "Arrival to completion, seconds",
    }

    def render_prometheus(self, gauges: Optional[dict] = None,
                          labeled: Optional[dict] = None) -> str:
        """Strict-Prometheus text exposition for ``/metrics``.

        Every metric family gets ``# HELP``/``# TYPE`` lines and
        caller-supplied gauge names are sanitized to the metric-name
        charset, so strict scrapers parse the page.  ``gauges`` are
        point-in-time values (queue depths, slot occupancy, pool
        utilization; names ending ``_total`` are typed counter).
        ``labeled`` maps family name -> (type, help, [(labels, value)])
        for labelled sample sets such as per-tier request outcomes.
        """
        snap = self.snapshot()
        lines: list[str] = []

        def fam(name: str, typ: str, help_: str, samples) -> None:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            lines.extend(samples)

        def fmt(val) -> str:
            if isinstance(val, bool):
                return str(int(val))
            return f"{val:g}" if isinstance(val, float) else f"{val}"

        for key, help_ in self._COUNTER_HELP.items():
            fam(f"server_{key}_total", "counter", help_,
                [f"server_{key}_total {snap[key]}"])
        for name, help_ in self._SUMMARY_HELP.items():
            s = snap[f"{name}_s"]
            base = f"server_{name}_seconds"
            fam(base, "summary", help_, [
                f'{base}{{quantile="0.5"}} {s["p50"]:.6f}',
                f'{base}{{quantile="0.99"}} {s["p99"]:.6f}',
                f"{base}_count {s['count']}",
                f"{base}_sum {s['sum']:.6f}",
            ])
        for key, val in (gauges or {}).items():
            name = sanitize_metric_name(f"server_{key}")
            typ = "counter" if name.endswith("_total") else "gauge"
            fam(name, typ, f"Point-in-time {key}", [f"{name} {fmt(val)}"])
        for key, (typ, help_, samples) in (labeled or {}).items():
            name = sanitize_metric_name(f"server_{key}")
            rendered = []
            for labels, val in samples:
                lbl = ",".join(
                    f'{sanitize_metric_name(k)}="{_escape_label(v)}"'
                    for k, v in sorted(labels.items()))
                rendered.append(f"{name}{{{lbl}}} {fmt(val)}")
            fam(name, typ, help_, rendered)
        return "\n".join(lines) + "\n"


def cache_report_data(policy, state, engine=None) -> dict:
    """Machine-readable cache/pool footprint: the dict behind serve.py's
    ``_cache_report`` print block and ``--stats-json``.  ``state`` is the
    engine's list of per-layer ``CacheState``s (the reference's is one
    layer-stacked state), None for a model without a KV cache; byte
    numbers come from the policy API, summed over layers."""
    if policy is None or state is None:
        return {"kv_applicable": False}
    states = list(state)
    is_paged = bool(states[0].is_paged)
    out = {
        "kv_applicable": True,
        "policy": policy.name,
        "layout": "paged pool" if is_paged else "slot cache",
        "persistent_bytes": int(sum(st.nbytes() for st in states)),
        "total_bytes": int(sum(st.nbytes(persistent_only=False)
                               for st in states)),
        "compression_ratio": float(
            states[0].policy.compression_ratio(states[0])),
    }
    per_shard = int(sum(st.nbytes(persistent_only=False, per_shard=True)
                        for st in states))
    if per_shard != out["total_bytes"]:
        # a cache sharded over a mesh (DESIGN.md §16): one device's
        # resident footprint too (K/V shrink by the shard count, the
        # replicated paging metadata does not)
        out["per_shard_bytes"] = per_shard
        out["per_shard_persistent_bytes"] = int(
            sum(st.nbytes(per_shard=True) for st in states))
    stats = engine.pool_stats() if engine is not None else None
    if stats:
        out["pool"] = stats
    if engine is not None and getattr(engine, "prefill_chunk", None):
        out["prefill_chunks"] = engine.n_prefill_chunks
        out["reused_prompt_tokens"] = engine.n_reused_tokens
    if engine is not None and getattr(engine, "spec_k", None):
        out["spec_k"] = engine.spec_k
        out["spec_tokens_drafted"] = int(engine.n_drafted)
        out["spec_tokens_accepted"] = int(engine.n_accepted)
        out["spec_tokens_rejected"] = int(engine.n_rejected)
        out["spec_acceptance_rate"] = (
            engine.n_accepted / max(engine.n_drafted, 1)
        )
    if engine is not None and getattr(engine, "tier_outcomes", None) \
            is not None:
        # which prefix tier each retired request was admitted from
        # (device COW / host restore / miss / none), split by outcome
        out["prefix_tier_outcomes"] = {
            tier: dict(byo) for tier, byo in engine.tier_outcomes.items()
        }
    return out
