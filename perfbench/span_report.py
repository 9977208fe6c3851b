"""The engine's own spans over one traced run of a cell, reduced to the
readings that per-layer metrics of the host's turn and of prefill would
take, and set against the profiled stretch's device trace.

    python perfbench/span_report.py --workload <name> --seed <n> \
        --seconds <s> [--out FILE]

runs the cell as ``run.py --trace 1`` does (the same harness, the same
window, the profiled stretch after the close) and prints one JSON line
(also written to ``--out``):

* ``result``: the run's own result line (its per-layer metrics);
* ``chunk_gap_ms``: the window's ``decode.device`` ``gap_ms`` summed
  over its chunks, over the decode steps they ran (device clock, no
  profiler): ms a step in which the device waited between chunks;
* ``turn_host_ms``: the window's ``engine.step`` spans less their
  ``decode.enqueue`` and ``decode.readback`` children, over the decode
  steps (host clock): the engine's own time between chunks;
* ``between_steps_ms``: host time between one ``engine.step`` and the
  next (the caller's), ms a step; ``per_step_ms``: each host span's
  mean ms a decode step;
* ``prefill_mfu``: ``costs.prefill_flops`` of set-up's monolithic
  prefills over their ``prefill.device`` time, as a share of the bf16
  peak (%); ``setup_split``: ``setup_s`` into the prefills' device
  seconds, the decode graph's capture and the rest;
* ``stretch``: the device trace's idle gaps of 50 us or more, each with
  the engine spans open across it (moved onto the profiler's clock by
  ``TraceRecorder.profiler_offset_ns``), and each chunk boundary inside
  the stretch: ``gap_ms`` from the events beside the trace's idle gap
  there.

It needs the port's ``host`` and ``device`` spans; on an engine without
them the readings that need them are null.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import weakref  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HOST = ("step.admit", "decode.upload", "decode.enqueue", "decode.readback",
        "step.scatter", "decode.chunk", "engine.step")
MIN_GAP_NS = 50_000


def _inside(s, o) -> bool:
    return o["t0"] <= s["t0"] and s["t1"] <= o["t1"]


def window_readings(spans: list, t_open: float, t_close: float) -> dict:
    """The window's readings from the recorder's spans (``harness._spans``
    form: name, t0, t1, args; perf_counter seconds)."""
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)
    for v in by.values():
        v.sort(key=lambda s: s["t0"])
    chunks = by.get("decode.chunk", [])
    dev = by.get("decode.device", [])
    paired = dev if len(dev) == len(chunks) else []
    win = [i for i, c in enumerate(chunks)
           if t_open <= c["t0"] and c["t1"] <= t_close]
    steps = sum(chunks[i]["args"]["steps"] for i in win)
    out = {"chunks": len(win), "decode_steps": steps}
    if not steps:
        return out
    gaps = [paired[i]["args"].get("gap_ms") for i in win] if paired else []
    out["chunk_gap_ms"] = (sum(gaps) / steps
                           if gaps and None not in gaps else None)
    out["chunk_dev_ms"] = (sum(paired[i]["args"]["dev_ms"] for i in win)
                           / steps if paired else None)
    engine = [s for s in by.get("engine.step", [])
              if t_open <= s["t0"] and s["t1"] <= t_close]
    per = {}
    for name in HOST:
        inner = [s for s in by.get(name, []) if any(
            _inside(s, e) for e in engine)] if name != "engine.step" \
            else engine
        per[name] = (1e3 * sum(s["t1"] - s["t0"] for s in inner) / steps
                     if inner else None)
    out["per_step_ms"] = per
    if per["decode.enqueue"] is not None:
        out["turn_host_ms"] = (per["engine.step"] - per["decode.enqueue"]
                               - per["decode.readback"])
    else:
        out["turn_host_ms"] = None
    out["between_steps_ms"] = 1e3 * sum(
        b["t0"] - a["t1"] for a, b in zip(engine, engine[1:])) / steps
    return out


def setup_readings(spans: list, t_open: float, setup_s: float, cfg,
                   capture_s) -> dict:
    from perfbench import costs

    pre = [s for s in spans if s["name"] == "prefill.device"
           and s["t0"] < t_open]
    host = [s for s in spans if s["name"] == "engine.prefill"
            and s["t1"] <= t_open]
    dev_s = sum(s["args"]["dev_ms"] for s in pre) / 1e3
    flops = sum(costs.prefill_flops(cfg, s["args"]["tokens"])
                * s["args"].get("rows", 1) for s in pre)
    return {
        "prefills": len(pre),
        "prefill_mfu": (100.0 * flops / dev_s / costs.PEAK_BF16_FLOPS
                        if dev_s else None),
        "prefill_flops": flops,
        "setup_split": {
            "setup_s": setup_s,
            "prefill_device_s": dev_s if pre else None,
            "prefill_enqueue_s": sum(s["t1"] - s["t0"] for s in host),
            "graph_capture_s": capture_s,
            "rest_s": (setup_s - dev_s - (capture_s or 0.0)) if pre
            else None}}


def stretch_readings(trace, spans: list, offset_ns: int) -> dict:
    """The stretch's idle gaps against the engine's spans, on the
    profiler's clock, and each chunk boundary's ``gap_ms`` beside the
    trace's idle gap there."""
    from perfbench import profile

    def ns(t):
        return round(t * 1e9) + offset_ns

    host = [(ns(s["t0"]), ns(s["t1"]), s["name"]) for s in spans
            if s["name"] in HOST]
    busy = profile._union(trace.ops, trace.start_ns, trace.end_ns)
    gaps, t = [], trace.start_ns
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    out = {"window_s": trace.window_s,
           "busy_s": sum(b - a for a, b in busy) / 1e9, "gaps": []}
    for a, b in gaps:
        if b - a < MIN_GAP_NS:
            continue
        over = {}
        for h0, h1, name in host:
            o = min(b, h1) - max(a, h0)
            if o > 0:
                over[name] = round(over.get(name, 0) + o / 1e6, 4)
        out["gaps"].append({"ms": (b - a) / 1e6, "spans": over})
    # a boundary: the idle gap that ends where the first device operation
    # after the chunk's host span began starts (its mask upload)
    chunks = sorted((s for s in spans if s["name"] == "decode.chunk"),
                    key=lambda s: s["t0"])
    dev = sorted((s for s in spans if s["name"] == "decode.device"),
                 key=lambda s: s["t0"])
    out["boundaries"] = []
    if len(dev) != len(chunks):
        return out
    for c, d in zip(chunks, dev):
        if not (trace.start_ns < ns(c["t0"]) and ns(c["t1"]) < trace.end_ns):
            continue
        first = next((a for a, _ in busy if a >= ns(c["t0"])), None)
        gap = next(((g0, g1) for g0, g1 in gaps if g1 == first), None)
        # the stretch's first gap is cut at its start: no boundary
        if gap is None or gap[0] == trace.start_ns \
                or "gap_ms" not in d["args"]:
            continue
        out["boundaries"].append({
            "gap_ms_events": d["args"]["gap_ms"],
            "gap_ms_trace": (gap[1] - gap[0]) / 1e6,
            "dev_ms_events": d["args"]["dev_ms"]})
    return out


def report(root: Path, workload: str, seed: int, seconds: float, *,
           device: str = "cuda", t_start=None) -> dict:
    """One traced run of ``workload`` through ``harness.run_cell``, with
    the recorder, the window and the stretch kept for the readings."""
    from perfbench import harness, profile

    kept = {}
    build, ctx_cls, stretch_cls = harness.build, harness.Ctx, \
        profile.Stretch

    def keep_build(*a, **k):
        out = build(*a, **k)
        kept["eng"], kept["rec"] = weakref.ref(out[2]), out[3]
        return out

    def keep_ctx(**k):
        graph = getattr(kept["eng"](), "_step_graph", None)
        kept["capture_s"] = getattr(graph, "capture_s", None)
        kept["ctx"] = ctx_cls(**k)
        return kept["ctx"]

    class KeepStretch(stretch_cls):
        def __exit__(self, *exc):
            r = super().__exit__(*exc)
            rec = kept["rec"]
            kept["offset_ns"] = rec.profiler_offset_ns() \
                if hasattr(rec, "profiler_offset_ns") else None
            kept["trace"] = self.trace
            return r

    harness.build, harness.Ctx, profile.Stretch = keep_build, keep_ctx, \
        KeepStretch
    try:
        out = harness.run_cell(root, workload, seed, seconds, True,
                               device=device, t_start=t_start)
    finally:
        harness.build, harness.Ctx, profile.Stretch = build, ctx_cls, \
            stretch_cls
    ctx, spans = kept["ctx"], harness._spans(kept["rec"])
    rep = {"workload": workload, "seed": seed, "result": out}
    rep.update(window_readings(spans, ctx.t_open, ctx.t_close))
    rep.update(setup_readings(spans, ctx.t_open, ctx.setup_s, ctx.cfg,
                              kept.get("capture_s")))
    if kept.get("trace") is not None and kept.get("offset_ns") is not None:
        rep["stretch"] = stretch_readings(kept["trace"], spans,
                                          kept["offset_ns"])
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["REPRO_BF16_DOTS"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    rep = report(ROOT, args.workload, args.seed, args.seconds,
                 t_start=T_START)
    line = json.dumps(rep)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
