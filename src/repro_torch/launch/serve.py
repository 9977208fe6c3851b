"""Serving CLI over the ``KVCachePolicy`` registry (port of
``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --max-batch 4 --requests 8 --prompt-len 64 --new-tokens 32 \
        [--smoke] [--device cpu] \
        [--policy {bf16,int4-srft,int8-per-token}] \
        [--backend {gather,blockwise,kernel}] [--paged] \
        [--temperature T] [--top-k K] [--chunk N] \
        [--http] [--port P] [--stats-json PATH] [--trace-out PATH] \
        [--calibrate] [--ckpt-dir DIR] [--mesh N|auto]

Builds the arch (optionally smoke-reduced), loads params from a
checkpoint or initializes them from ``--seed``, optionally calibrates
per-channel lambda from one forward pass over a prompt stream (the
paper's recipe, §7.3), then serves requests through the
continuous-batching engine (``launch/batch_engine.py``): up to
``--max-batch`` requests share one ragged slot cache (or, ``--paged``,
the page pool), each decode step is one CUDA graph replay on a card,
finished rows are masked and their slots refilled.

Two front-ends over the same engine:

* the default **closed-loop queue** -- a seeded mixed-prompt-length
  workload (``launch/server/trace.py``) streamed to stdout, reporting
  aggregate tok/s and the policy-API compression/footprint block;
* ``--http`` -- the threaded prefill/decode/detokenize pipeline behind a
  stdlib HTTP/SSE server (``POST /v1/completions`` with ``"stream":
  true``, ``/healthz``, ``/metrics``, ``/debug/trace``).  SIGINT drains
  live streams, retires every slot and prints the final stats block
  before exiting; a second SIGINT cancels instead of draining.

``--stats-json`` writes the machine-readable twin of the report block
(plus server metrics when serving over HTTP); ``--trace-out`` writes the
trace ring at exit, and SIGUSR1 dumps its last ``--flight-window``
seconds while the server runs.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card and
without that flag it raises before building anything.  ``--mesh N``
(ref ``serve.py:167-170``, ``:318-343``) shards the KV cache by head over
a ``(1, N)`` ('data', 'model') mesh of the first N visible cards (params
and the scheduler on the first; DESIGN.md §16): N = 1, or a host with
one device, means no mesh, and an N above the visible cards exits with
the reference's message.  A simulated mesh, one device repeated, is
built from Python (``launch/mesh.py``) and passed to the engines.  The
report and ``/healthz`` add one device's bytes (``per_shard_bytes``)
where they differ from the global figure.  The dense, moe and vlm families go
through the ragged ``BatchEngine`` (a vlm's requests are text only, as the
reference's are).  The hybrid, ssm and audio families are served
single-stream (ref ``serve.py:259-267``, ``_serve_single_stream``): one
batch of equal-length prompts through ``Engine`` (a CUDA graph per step
on a card), where ``--spec-k`` exits with the reference's error and
``--http``, ``--paged`` and ``--prefill-chunk`` print the reference's
notes and are ignored.  An audio prompt is AUDIO_FRAMES stub frame
embeddings drawn from ``--seed`` plus the tokens (the reference's CLI
stops at its cache's missing ``s_enc`` there).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import signal
import threading
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTENTION_FAMILIES
from repro_torch.core import calibrate as C
from repro_torch.core.cache_api import AttendBackend, available_policies
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.launch.batch_engine import BatchEngine
from repro_torch.launch.engine import Engine, Sampler, mesh_allows_graph
from repro_torch.launch.mesh import make_mesh, visible_cards
from repro_torch.launch.server import (
    CompletionServer,
    ServingPipeline,
    TraceRecorder,
)
from repro_torch.launch.server.stats import cache_report_data
from repro_torch.launch.server.trace import make_requests
from repro_torch.launch.train import smoke_config
from repro_torch.models import build_model

__all__ = ["calibrate_lambdas", "main"]

AUDIO_FRAMES = 1500  # whisper's 30 s window of encoder frames


def calibrate_lambdas(model, params, tokens, rots):
    """Static per-channel lambda from one forward pass (paper §7.1):
    ``rots`` and the result are one (k, v) ``Rotation`` pair per layer."""
    k_act, v_act = model.collect_kv(params, tokens)
    d = k_act.shape[-1]
    out = []
    for i, (rk, rv) in enumerate(rots):
        out.append(tuple(
            C.apply_static_lambda(rot, C.static_lambda(rot, act[i]
                                                       .reshape(-1, d)))
            for rot, act in ((rk, k_act), (rv, v_act))))
    return out


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="slot-cache capacity: max requests decoding "
                         "together")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of queued requests (mixed prompt "
                         "lengths) to serve")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode tokens per scheduler quantum")
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="longest prompt; the queue mixes this with "
                         "shorter ones (ragged batching)")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--run-len", type=int, default=1,
                    help="consecutive same-length prompts in the "
                         "workload (runs > 1 let bucketed admission "
                         "pack them into one batched prefill)")
    ap.add_argument("--policy", default=None,
                    help=f"cache policy name (default: config; "
                         f"registered: {', '.join(available_policies())})")
    ap.add_argument("--backend", default="gather",
                    choices=[b.value for b in AttendBackend],
                    help="attention read path for decode")
    ap.add_argument("--no-quant", action="store_true",
                    help="shorthand for --policy bf16")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged KV pool (block "
                         "allocator + page tables + COW prefix sharing)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per physical page (int4: a multiple of "
                         "the flush window W)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="physical pages in the pool (default: the dense "
                         "slot footprint; fewer oversubscribe it and "
                         "exercise LRU preemption)")
    ap.add_argument("--offload-bytes", type=int, default=None,
                    help="host-RAM budget (bytes) of the prefix-page "
                         "offload tier (requires --paged and "
                         "--prefill-chunk)")
    ap.add_argument("--offload-dir", default=None,
                    help="optional disk spill directory behind the host "
                         "tier")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked admission: N-token prompt chunks "
                         "interleaved with decode (a multiple of the "
                         "policy window and, with --paged, of "
                         "--page-size)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="prompt tokens admitted per scheduler quantum "
                         "(default: one chunk)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="self-speculative decoding: K-token verify "
                         "passes, greedy only, output equal to plain "
                         "decode")
    ap.add_argument("--mesh", default=None,
                    help="N | auto: shard the KV cache by head over a "
                         "(1, N) ('data', 'model') mesh of visible cards, "
                         "params and scheduler on the first (N=1: no "
                         "mesh)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k highest logits")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP/SSE through the threaded "
                         "pipeline instead of the closed-loop queue")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="HTTP port (0 = ephemeral, printed at boot)")
    ap.add_argument("--admit-queue", type=int, default=64,
                    help="bounded intake depth; a full queue returns "
                         "HTTP 429 (backpressure)")
    ap.add_argument("--s-max", type=int, default=None,
                    help="slot capacity in tokens (default: prompt-len "
                         "+ new-tokens, window-aligned)")
    ap.add_argument("--stats-json", default=None,
                    help="write the cache/pool report (and, with "
                         "--http, server metrics) as JSON to this path")
    ap.add_argument("--trace-out", default=None,
                    help="write the trace ring as Chrome trace-event "
                         "JSON here at exit")
    ap.add_argument("--trace-buffer", type=int, default=65536,
                    help="trace ring capacity in events (drop-oldest)")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable the trace recorder (on by default)")
    ap.add_argument("--flight-window", type=float, default=30.0,
                    help="SIGUSR1 dumps the last N seconds of the trace "
                         "ring")
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = _build_mesh(args.mesh, dev)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    model = build_model(cfg, device=dev)
    if not cfg.kv_applicable:
        print(f"[note] {cfg.name} has no attention KV cache "
              f"(family={cfg.family}); running its recurrent-state path")
    params = model.init(model.generator(args.seed))
    if args.ckpt_dir:
        from repro_torch.optim.adam import adam_init

        ckpt = CheckpointManager(args.ckpt_dir)
        last = ckpt.latest_step()
        if last is not None:
            (params, _opt), _ = ckpt.restore(last,
                                             (params, adam_init(params)))
            del _opt
            print(f"[load] checkpoint step {last}")

    policy_name = "bf16" if args.no_quant else args.policy
    policy = model.cache_policy(policy_name) if cfg.kv_applicable else None
    backend = AttendBackend.parse(args.backend)
    attention_only = cfg.family in ATTENTION_FAMILIES

    rots = None
    if args.calibrate and hasattr(policy, "rotation") and not attention_only:
        # collect_kv, the calibration pass, runs pure-attention families
        print(f"[calibrate] skipped: family={cfg.family} has no "
              f"KV-collection pass")
    elif args.calibrate and hasattr(policy, "rotation"):
        it = DataIterator(SyntheticCorpus(args.seed + 1), batch_per_shard=4,
                          seq_len=args.prompt_len, device=dev)
        calib = it.next()["tokens"]
        rots = model.init_rotations(torch.Generator().manual_seed(7))
        t0 = time.time()
        with torch.no_grad():
            rots = calibrate_lambdas(model, params, calib, rots)
        print(f"[calibrate] per-channel lambda in {time.time() - t0:.1f}s")

    sampler = Sampler(temperature=args.temperature, top_k=args.top_k)
    if not attention_only:
        it = DataIterator(SyntheticCorpus(args.seed + 1),
                          batch_per_shard=max(args.requests, 1),
                          seq_len=args.prompt_len, device=dev)
        return _serve_single_stream(cfg, model, params, it.next()["tokens"],
                                    policy, backend, sampler, args, rots,
                                    mesh=mesh)
    window = getattr(policy, "window", 1)
    s_max = args.s_max
    if s_max is None:
        s_max = args.prompt_len + args.new_tokens + window
        if args.spec_k:
            # a verify pass appends spec_k tokens past the last kept
            # position (BatchEngine._validate enforces this)
            s_max += args.spec_k
        s_max += (-s_max) % max(window, 1)
    trace = TraceRecorder(capacity=args.trace_buffer,
                          enabled=not args.no_trace)
    engine = BatchEngine(
        model, params, capacity=args.max_batch, s_max=s_max, policy=policy,
        backend=backend, sampler=sampler, chunk=args.chunk, rots=rots,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 2),
        paged=args.paged, page_size=args.page_size, n_pages=args.pool_pages,
        device=dev, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget,
        offload_bytes=args.offload_bytes, offload_dir=args.offload_dir,
        spec_k=args.spec_k, trace=trace, mesh=mesh)
    _install_flight_recorder(trace, args)
    offload = (f", host offload {args.offload_bytes / 2**20:.0f} MiB"
               + (f" (+disk {args.offload_dir})" if args.offload_dir else "")
               if args.offload_bytes else "")
    layout = (f"paged pool: {engine.n_pages - 1} pages x "
              f"{engine.page_size} tok, COW prefix sharing{offload}"
              if args.paged else "ragged slot cache")
    admission = (f"chunked prefill: {args.prefill_chunk} tok/chunk, "
                 f"{engine.prefill_budget} tok/quantum"
                 if args.prefill_chunk else "monolithic prefill")
    mode = "http/sse pipeline" if args.http else "closed-loop queue"
    if mesh is not None:
        mode += (f"; mesh-sharded x{mesh.shape['model']} "
                 f"(KV by head, bit-identical)")
    spec = (f" spec-k={args.spec_k} (self-speculative, equal to plain)"
            if args.spec_k else "")
    step = "one CUDA graph per step" if engine.graph else "eager steps"
    print(f"[serve] arch={cfg.name} policy={policy.name} "
          f"backend={engine.backend.value} device={dev} "
          f"max-batch={args.max_batch} new={args.new_tokens} "
          f"chunk={args.chunk}{spec} ({mode}; continuous batching: "
          f"{layout}, {admission}, {step})")

    if args.http:
        return _serve_http(cfg, engine, policy, args)
    return _serve_queue(engine, policy, args)


def _build_mesh(arg, dev):
    """--mesh N | auto -> a (1, N) ('data', 'model') mesh of the first N
    visible devices (the cards; the CPU is one device), or None for N = 1
    or a one-device host.  The serving mesh only shards over 'model' (KV
    heads); 'data' is there so the partitioning rules apply unchanged."""
    if arg is None:
        return None
    devs = visible_cards() if dev.type == "cuda" else [dev]
    n = len(devs) if arg == "auto" else int(arg)
    if n <= 1:
        return None
    if n > len(devs):
        raise SystemExit(
            f"error: --mesh {n} asks for more devices than the {len(devs)} "
            f"visible (a simulated mesh repeats one device: build it from "
            f"Python with repro_torch.launch.mesh.make_mesh((1, {n}), "
            f"('data', 'model'), devices=['{devs[0]}'] * {n}) and pass it "
            f"as BatchEngine(mesh=) or Engine(mesh=))")
    return make_mesh((1, n), ("data", "model"), devs[:n])


def _install_flight_recorder(trace: TraceRecorder, args) -> None:
    """SIGUSR1 -> dump the last ``--flight-window`` seconds of the trace
    ring to disk: when a stall is noticed after the fact, the evidence is
    still in the buffer.  The dump runs on its own thread -- the signal
    handler must not block the interrupted serving thread on file IO."""
    if not hasattr(signal, "SIGUSR1"):  # not on this platform
        return
    seq = itertools.count(1)

    def _dump() -> None:
        base = args.trace_out or "trace.json"
        root, ext = os.path.splitext(base)
        path = f"{root}.flight-{next(seq)}{ext or '.json'}"
        n = trace.write(path, last_s=args.flight_window)
        print(f"[trace] flight dump: {n} events "
              f"(last {args.flight_window:g}s) -> {path}", flush=True)

    def _handler(signum, frame):
        threading.Thread(target=_dump, daemon=True).start()

    signal.signal(signal.SIGUSR1, _handler)


def _write_trace_out(trace: TraceRecorder, args) -> None:
    if not args.trace_out:
        return
    n = trace.write(args.trace_out)
    print(f"  [trace] wrote {n} events ({trace.dropped} dropped) "
          f"-> {args.trace_out}")


def _serve_queue(engine: BatchEngine, policy, args) -> None:
    """The closed-loop stdout path: a seeded mixed-length workload
    (``launch/server/trace.py``) streamed chunk by chunk.
    KeyboardInterrupt drains: live requests are cancelled through
    ``cancel_all`` (slots retired, pages freed) and the final stats block
    still prints."""
    requests = make_requests(args.requests, prompt_len=args.prompt_len,
                             new_tokens=args.new_tokens, seed=args.seed,
                             run_len=args.run_len)
    for r in requests:
        engine.submit(r)
    t0 = time.time()
    n_tok = 0
    done = []
    timings = {}
    interrupted = False
    try:
        while engine.has_work:
            events, completions = engine.step()
            for rid, toks in events:  # streaming, chunk granularity
                n_tok += len(toks)
            for comp in completions:
                done.append(comp)
                _print_completion(comp)
                t = engine.trace.req_timing(comp.rid)
                if t is not None:
                    timings[str(comp.rid)] = t
    except KeyboardInterrupt:
        interrupted = True
        for comp in engine.cancel_all():
            done.append(comp)
            _print_completion(comp)
    t_total = time.time() - t0

    note = "interrupted; drained" if interrupted else "served"
    print(f"  {note} {len(done)} requests, {n_tok} tokens in "
          f"{t_total:.2f}s -> {n_tok / max(t_total, 1e-9):.1f} tok/s "
          f"aggregate on {engine.device}"
          + (" (first graph capture included)" if engine.graph else ""))
    if args.prefill_chunk:
        print(f"  admission: {engine.n_prefill_chunks} prefill chunks, "
              f"{engine.n_reused_tokens} prompt tokens skipped via "
              f"token-level prefix reuse")
    if args.spec_k:
        rate = engine.n_accepted / max(engine.n_drafted, 1)
        print(f"  speculative: {engine.n_accepted}/{engine.n_drafted} "
              f"drafted tokens accepted ({100 * rate:.0f}%; spec-k="
              f"{args.spec_k}, output equal to plain decode)")
    data = _cache_report(policy, engine.cache["attn"], engine=engine)
    payload = {
        "mode": "queue", "interrupted": interrupted,
        "requests_done": len(done), "tokens": n_tok,
        "aggregate_tok_s": n_tok / max(t_total, 1e-9),
        "cache": data,
    }
    if timings:
        payload["timings"] = timings
    _write_stats_json(args.stats_json, payload)
    _write_trace_out(engine.trace, args)


def _serve_http(cfg, engine: BatchEngine, policy, args) -> None:
    """The threaded pipeline behind the SSE server.  The first SIGINT
    stops accepting and DRAINS live streams before exiting (slots
    retired, pages freed, final stats printed); a second SIGINT cancels
    the drain and closes streams with ``finish_reason="cancelled"``."""
    pipeline = ServingPipeline(engine, admit_queue=args.admit_queue,
                               trace=engine.trace)
    pipeline.start()
    server = CompletionServer(pipeline, host=args.host, port=args.port,
                              vocab_size=cfg.vocab_size)
    print(f"[serve] listening on {server.url}  (POST /v1/completions, "
          f"GET /healthz, GET /metrics, GET /debug/trace)", flush=True)

    n_int = 0

    def _sigint(signum, frame):
        nonlocal n_int
        n_int += 1
        # serve_forever must be unblocked from another thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, _sigint)
    try:
        server.serve_forever()
    finally:
        cancel = n_int > 1
        print(f"[serve] {'cancelling' if cancel else 'draining'} "
              f"live streams ...")
        drained = pipeline.shutdown(cancel=cancel)
        snap = pipeline.metrics.snapshot()
        print(f"  {'drained' if drained else 'DRAIN TIMED OUT'}: "
              f"{snap['requests_completed']} completed, "
              f"{snap['requests_cancelled']} cancelled, "
              f"{snap['requests_rejected']} rejected (429), "
              f"{snap['tokens_streamed']} tokens streamed")
        ttft, itl = snap["ttft_s"], snap["itl_s"]
        if ttft["count"]:
            print(f"  ttft p50={ttft['p50'] * 1e3:.0f}ms "
                  f"p99={ttft['p99'] * 1e3:.0f}ms   "
                  f"itl p50={itl['p50'] * 1e3:.1f}ms "
                  f"p99={itl['p99'] * 1e3:.1f}ms")
        data = _cache_report(policy, engine.cache["attn"], engine=engine)
        _write_stats_json(args.stats_json, {
            "mode": "http", "drained": drained, "server": snap,
            "queues": pipeline.queue_depths(), "cache": data,
        })
        _write_trace_out(engine.trace, args)


def _serve_single_stream(cfg, model, params, prompt, policy, backend,
                         sampler, args, rots=None, mesh=None) -> None:
    """The recurrent and audio families (ref ``serve.py:551-625``): one
    batch of equal-length prompts through ``Engine``, prefill then decode
    (one CUDA graph per step on a card, on a cache that keeps its lengths
    on the device)."""
    if args.spec_k:
        raise SystemExit(
            f"error: --spec-k requires the continuous-batching engine, "
            f"but family={cfg.family} is served single-stream: recurrent "
            f"state (ssm/hybrid/audio) has no truncate_rows rollback "
            f"path, so a rejected draft could not be rewound.  Drop "
            f"--spec-k or serve a pure-attention arch (dense/moe/vlm).")
    if args.http:
        print(f"[note] --http needs a pure-attention family "
              f"(got {cfg.family}); serving the closed-loop path")
    if args.paged:
        print(f"[note] --paged needs a pure-attention family "
              f"(got {cfg.family}); serving dense single-stream")
    if args.prefill_chunk:
        print(f"[note] --prefill-chunk needs the continuous-batching "
              f"engine (family={cfg.family} is served single-stream); "
              f"running one monolithic prefill")
    dev = model.device
    window = getattr(policy, "window", 1) if policy is not None else 1
    s_max = args.prompt_len + args.new_tokens + window
    s_max += (-s_max) % max(window, 1)
    batch = min(args.max_batch, prompt.shape[0])
    prompt = prompt[:batch]
    # a graph replays device lengths; a mesh over several cards is eager
    graph = dev.type == "cuda" and mesh_allows_graph(mesh, None)
    init = torch.Generator().manual_seed(7)
    if cfg.family == "audio":
        frames = torch.randn((batch, AUDIO_FRAMES, cfg.d_model),
                             generator=torch.Generator().manual_seed(
                                 args.seed + 3)).to(dev)
        cache = model.init_cache(batch, s_max, AUDIO_FRAMES, policy=policy,
                                 generator=init, ragged=graph)
        prompt = (frames, prompt)
    else:
        cache = model.init_cache(batch, s_max, policy=policy, rots=rots,
                                 generator=init, ragged=graph)
    engine = Engine(model, backend=backend, sampler=sampler, graph=graph,
                    mesh=mesh)
    params = engine.shard_params(params)
    cache = engine.shard_cache(cache)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)

    def sync():
        if graph:
            torch.cuda.synchronize()

    with torch.inference_mode():
        t0 = time.time()
        logits, cache = engine.prefill(params, prompt, cache)
        sync()
        t_prefill = time.time() - t0
        tok = sampler.sample(logits[:, -1], gen)[:, None]
        n_steps = args.new_tokens - 1
        t0 = time.time()
        rest, cache = engine.decode(params, tok, cache, n_steps,
                                    generator=gen)
        sync()
        t_decode = time.time() - t0
    gen_toks = torch.cat([tok, rest], dim=1).cpu()

    pname = policy.name if policy is not None else "-"
    ms_tok = t_decode * 1e3 / max(n_steps, 1)
    step = "one CUDA graph per step" if graph else "eager steps"
    print(f"[serve] arch={cfg.name} policy={pname} "
          f"backend={engine.backend.value} batch={batch} "
          f"prompt={args.prompt_len} new={args.new_tokens} "
          f"({step}; single-stream family)")
    print(f"  prefill: {t_prefill * 1e3:.0f} ms "
          f"({batch * args.prompt_len / max(t_prefill, 1e-9):.0f} prompt "
          f"tok/s)")
    print(f"  decode:  {ms_tok:.1f} ms/tok   "
          f"{batch * n_steps / max(t_decode, 1e-9):.1f} tok/s decode-only "
          f"on {dev}" + (" (first graph capture included)" if graph else ""))
    states = (cache["self"] + cache["cross"] if cfg.family == "audio"
              else cache.get("attn"))
    data = _cache_report(policy, states)
    _write_stats_json(args.stats_json, {
        "mode": "single-stream", "cache": data,
        "decode_ms_per_tok": ms_tok,
    })
    sample = "".join(chr(c) if 32 <= c < 127 else "?"
                     for c in gen_toks[0].tolist())
    print(f"  sample continuation (byte-decoded): {sample!r}")


def _print_completion(comp) -> None:
    text = "".join(chr(c) if 32 <= c < 127 else "?"
                   for c in comp.tokens[:24].tolist())
    print(f"  [done] rid={comp.rid} prompt={comp.prompt_len} "
          f"+{len(comp.tokens)} tok ({comp.finish_reason}) {text!r}")


def _write_stats_json(path, payload) -> None:
    if not path:
        return
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"  [stats] wrote {path}")


def _cache_report(policy, state, *, engine=None, indent="  ") -> dict:
    """One compression/footprint report for both front-ends: prints the
    human block and returns the machine-readable dict
    (``server/stats.py:cache_report_data``, what ``--stats-json``
    writes)."""
    data = cache_report_data(policy, state, engine)
    if not data["kv_applicable"]:
        print(f"{indent}(no attention KV cache: recurrent-state family)")
        return data
    is_paged = data["layout"] == "paged pool"
    extra = "residual+paging metadata" if is_paged else "transient state"
    print(f"{indent}{data['layout']} persistent KV: "
          f"{data['persistent_bytes'] / 1e3:.1f} KB "
          f"({data['compression_ratio']:.2f}x vs bf16, policy API; "
          f"{data['total_bytes'] / 1e3:.1f} KB with {extra})")
    if "per_shard_bytes" in data:
        print(f"{indent}per shard (one device of the mesh): "
              f"{data['per_shard_persistent_bytes'] / 1e3:.1f} KB "
              f"persistent KV, {data['per_shard_bytes'] / 1e3:.1f} KB with "
              f"{extra}")
    stats = data.get("pool")
    if stats:
        print(f"{indent}pool: {stats['pages_used']}/{stats['n_pages']} "
              f"pages used ({100 * stats['utilization']:.0f}%, peak "
              f"{stats['peak_pages']}), {stats['pages_per_request']:.1f} "
              f"pages/request, {stats['shared_pages']} COW-shared, "
              f"{stats['preemptions']} preemptions")
        print(f"{indent}pool bytes: {stats['used_page_bytes'] / 1e3:.1f} KB "
              f"live of {stats['pool_bytes'] / 1e3:.1f} KB pool "
              f"(dense slot equivalent "
              f"{stats['dense_equiv_bytes'] / 1e3:.1f} KB)")
        hb = stats["host_bytes"]
        mirrors = hb["refcount_mirror"] + hb["page_table_mirror"]
        print(f"{indent}host bytes: {hb['total'] / 1e3:.1f} KB "
              f"(mirrors {mirrors / 1e3:.1f} KB, "
              f"prefix index {hb['prefix_index'] / 1e3:.1f} KB, "
              f"offload store {hb['offload_store'] / 1e3:.1f} KB)")
        off = stats["offload"]
        if off["enabled"]:
            st = off["store"]
            print(f"{indent}offload tier: {off['spilled_pages']} pages "
                  f"spilled, {off['restored_pages']} restored "
                  f"({off['restored_tokens']} tokens); hits "
                  f"device={off['hits_device']} host={off['hits_host']} "
                  f"miss={off['misses']}; store "
                  f"{st['ram_bytes'] / 1e3:.1f} KB RAM + "
                  f"{st['disk_bytes'] / 1e3:.1f} KB disk of "
                  f"{st['capacity_bytes'] / 1e3:.1f} KB")
    return data


if __name__ == "__main__":
    main()
