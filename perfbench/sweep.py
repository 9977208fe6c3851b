"""Find an open cell's knee by a rate sweep on the card: the highest of a
few fixed arrival rates that the engine sustains without a growing
backlog.  The model and engine are built once; each rate runs the cell's
mix (its sizes, its engine) for ``warmup_s`` and then a window of
``--seconds``, and the engine is emptied before the next.

    python perfbench/sweep.py --workload <name> --rates 3 4 5 6 8 \
        --seconds 20 [--seed N]

For each rate it prints: requests due in the window, the share of them
that had their first token by the window's close (attainment), the
queue (requests submitted and not yet admitted) at the window's open and
close, the time to first token's p50 / p90 of those served, and output
tokens per second against the tokens per second offered (the output
budgets of the requests due in the window over its seconds).
Attainment counts the requests due at least 2 s before the close.  A
rate is sustained when the output keeps up with the offer (at least 0.9
of it), the queue at the close is no more than 4 above the queue at the
open, and attainment is at least 0.9.  With long outputs the slots fill
slowly, so a short window can pass a rate the engine cannot hold: the
output the engine reaches above the knee, over the mean output budget,
is the rate it can hold.  Sweeping stops after two rates in a row are
not sustained.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MARGIN_S = 2.0


def serve_rate(harness, traffic_mod, stats, client, cell, cfg, seed, rate,
               seconds) -> dict:
    tr = dict(cell.traffic, rate=rate)
    specs = traffic_mod.make_requests(tr, cfg.vocab_size, seed,
                                      s_max=client.eng.s_max,
                                      seconds=seconds)
    client.specs = {s.rid: s for s in specs}
    t0 = time.perf_counter()
    due = {s.rid: t0 + s.due for s in specs}
    t_open, t_close = t0 + tr["warmup_s"], t0 + tr["warmup_s"] + seconds
    nxt, q_open = 0, None
    while True:
        # the cells' own open loop (harness.offer), between steps
        nxt, ready = harness.offer(client, specs, due, nxt)
        now = time.perf_counter()
        if q_open is None and now >= t_open:
            q_open = client.eng.pending
        if now >= t_close:
            break
        if ready:
            client.step()
    q_close = client.eng.pending
    in_win = [r for r, t in due.items() if t_open < t <= t_close]
    # attainment: of the requests due at least MARGIN_S before the close,
    # the share that had their first token by then
    judged = [r for r in in_win if due[r] <= t_close - MARGIN_S]
    served = [r for r in judged if r in client.first
              and client.first[r] <= t_close]
    ttft = [client.first[r] - due[r] for r in in_win if r in client.first]
    n_tok = sum(k for ds in client.deliveries.values() for t, k in ds
                if t_open < t <= t_close)
    offered = sum(client.specs[r].max_new for r in in_win) / seconds
    client.eng.cancel_all()
    for r in list(client.served):
        client.forget(r)
    out = {"rate": rate, "due": len(in_win),
           "attainment": len(served) / max(len(judged), 1),
           "queue_open": q_open, "queue_close": q_close,
           "ttft_p50_ms": 1000 * (stats.percentile(ttft, 50) or 0),
           "ttft_p90_ms": 1000 * (stats.percentile(ttft, 90) or 0),
           "output_tok_s": n_tok / seconds, "offered_tok_s": offered}
    out["sustained"] = bool(q_close <= q_open + 4
                            and out["attainment"] >= 0.9
                            and out["output_tok_s"] >= 0.9 * offered)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=5_000_000_001)
    args = ap.parse_args(argv)
    os.environ["REPRO_BF16_DOTS"] = "1"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import harness, stats, traffic as traffic_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.resolve(ROOT, args.workload)
    if cell.traffic["kind"] != "open":
        raise SystemExit(f"{args.workload} is not an open-loop cell")
    cfg = harness.model_config(cell.config)
    _, _, eng, _ = harness.build(cell, cfg, args.seed, "cuda", False)
    client = harness.Client(eng, [], annotate=False)
    harness.warm_open(client, cell, cfg, args.seed)
    results, misses = [], 0
    for rate in sorted(args.rates):
        r = serve_rate(harness, traffic_mod, stats, client, cell, cfg,
                       args.seed, rate, args.seconds)
        results.append(r)
        print(json.dumps(r), flush=True)
        misses = 0 if r["sustained"] else misses + 1
        if misses == 2:
            break
    ok = [r["rate"] for r in results if r["sustained"]]
    print(json.dumps({"workload": args.workload, "knee": max(ok) if ok
                      else None, "sweep": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
