"""One cell of the benchmark, start to finish.

``run_cell`` reads the cell's entry in ``BENCHMARK.json`` and, by name,
its configuration (``configs/``), its traffic mix (``traffic/``), its
correctness limits (``checks/<cell>.json``) and one reader per metric
(``metrics/<metric>.py``, each exposing ``read(ctx) -> float | None``).
Adding a cell, a mix or a metric takes new files and entries only.

A run, all on one device:

1. set-up: the model's weights and the cache's rotations are drawn on the
   device from ``--seed``; the port's ``BatchEngine`` is built (paged
   int4-srft cache, the KERNEL read, the decode graph on a card) and the
   traffic's shapes are warmed up (a closed mix admits every session, an
   open mix serves one request of its longest prompt, then arrivals run
   for ``warmup_s``);
2. the window: ``BatchEngine.step`` until ``--seconds`` have passed; it
   closes at the end of the step that crosses the deadline.  An open mix
   submits each request when it is due, between steps.  With
   ``--trace 1`` the engine's ``TraceRecorder`` is on, and the fixed
   number of steps that follow the close (``profile`` in the traffic
   file) run under the profiler, so that its cost stays out of the
   window;
3. after the window: the requests due in it are served to their first
   token (open mixes, at most ``drain_s``), the peak memory is read, the
   engine is freed, and the plain reference (``reference/``) scores a
   seeded sample of served streams: ``correct`` holds when no request
   failed and no served token's reference logit lies further below the
   reference's best than the cell's limit.

The result is one JSON line (the last of standard output).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from perfbench import profile, traffic as traffic_mod
from perfbench.reference.compare import control_gaps, gaps
from perfbench.reference.model import Reference, hyper_from_config

__all__ = ["FORBIDDEN", "forbidden_modules", "Cell", "resolve",
           "model_config", "make_weights", "offer", "run_cell"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
ANNOTATIONS = {"engine.step", "engine.admit", "decode.chunk"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    bench: Path


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` and its files, found by name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "perfbench"
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads(
            (bench / "traffic" / f"{w['traffic']}.json").read_text()),
        check=json.loads((bench / "checks" / f"{workload}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
        bench=bench)


def load_reader(bench: Path, name: str):
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(cj: dict):
    """The port's ``ModelConfig`` for a config.json-style file."""
    from repro_torch.configs.base import ModelConfig

    act = {"silu": "swiglu", "gelu_pytorch_tanh": "geglu"}[cj["hidden_act"]]
    heads = cj["num_attention_heads"]
    return ModelConfig(
        name=cj["name"], family="dense", n_layers=cj["num_hidden_layers"],
        d_model=cj["hidden_size"], n_heads=heads,
        n_kv_heads=cj["num_key_value_heads"],
        head_dim=cj.get("head_dim") or cj["hidden_size"] // heads,
        d_ff=cj["intermediate_size"], vocab_size=cj["vocab_size"],
        qk_norm=bool(cj.get("qk_norm", False)),
        qkv_bias=bool(cj.get("attention_bias", cj.get("bias", False))),
        rope_theta=float(cj["rope_theta"]), ffn_activation=act,
        norm_eps=float(cj["rms_norm_eps"]),
        tie_embeddings=bool(cj.get("tie_word_embeddings", False)),
    ).validated()


def make_weights(cfg, seed: int, device) -> tuple[dict, torch.Tensor]:
    """bf16 weights in the tree the port's ``LM`` takes, norm scales in
    fp32 (weight = 1 + scale), and the cache rotations' signs (n_layers,
    2, head_dim), all drawn on ``device`` from ``seed``, one call a layer
    for the matrices."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))

    def normal(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=device, dtype=dtype)

    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    H, Hk, Fd, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    mats = [("wq", (d, H, hd), d), ("wk", (d, Hk, hd), d),
            ("wv", (d, Hk, hd), d), ("wo", (H * hd, d), H * hd),
            ("w_gate", (d, Fd), d), ("w_up", (d, Fd), d),
            ("w_down", (Fd, d), Fd)]
    per_layer = sum(int(np.prod(s)) for _, s, _ in mats)
    ln = normal((L, 2, d), torch.float32).mul_(0.1)
    qkn = normal((L, 2, hd), torch.float32).mul_(0.1)
    blocks = []
    for i in range(L):
        flat = normal((per_layer,))
        parts, off = {}, 0
        for name, shape, fan in mats:
            n = int(np.prod(shape))
            parts[name] = flat[off:off + n].view(shape).mul_(fan ** -0.5)
            off += n
        attn = {k: {"w": parts[k]} for k in ("wq", "wk", "wv", "wo")}
        if cfg.qkv_bias:
            for k, h in (("wq", H), ("wk", Hk), ("wv", Hk)):
                attn[k]["b"] = normal((h, hd)).mul_(0.02)
        if cfg.qk_norm:
            attn["q_norm"] = {"scale": qkn[i, 0]}
            attn["k_norm"] = {"scale": qkn[i, 1]}
        blocks.append({
            "ln_attn": {"scale": ln[i, 0]}, "attn": attn,
            "ln_ffn": {"scale": ln[i, 1]},
            "ffn": {k: {"w": parts[k]} for k in ("w_gate", "w_up",
                                                  "w_down")}})
    params = {"embed": {"embedding": normal((V, d)).mul_(0.02)},
              "ln_final": {"scale": normal((d,), torch.float32).mul_(0.1)},
              "blocks": blocks}
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": normal((d, V)).mul_(d ** -0.5)}
    u = torch.rand((L, 2, hd), generator=g, device=device)
    signs = torch.where(u < 0.5, 1.0, -1.0).to(torch.float32)
    return params, signs


def _rotations(signs: torch.Tensor):
    from repro_torch.core.transforms import Rotation, transform_matrix

    hd = signs.shape[-1]
    return [tuple(Rotation(matrix=transform_matrix("srft", s),
                           lam=torch.ones(hd, device=s.device),
                           signs=s.contiguous(), kind="srft")
                  for s in (signs[i, 0], signs[i, 1]))
            for i in range(signs.shape[0])]


def build(cell: Cell, cfg, seed: int, device, trace: bool):
    """The weights, the rotations' signs, the engine the traffic file
    describes and its trace recorder (on when ``trace``)."""
    from repro_torch.launch.batch_engine import BatchEngine
    from repro_torch.launch.server.tracing import TraceRecorder
    from repro_torch.models.lm import LM

    e = cell.traffic["engine"]
    params, signs = make_weights(cfg, seed, device)
    rec = TraceRecorder(capacity=1 << 20, enabled=trace)
    eng = BatchEngine(
        LM(cfg, device=device), params, capacity=e["capacity"],
        s_max=e["s_max"], policy=e["policy"], backend=e["backend"],
        paged=e["paged"], page_size=e["page_size"], chunk=e["chunk"],
        eos_id=None, rots=_rotations(signs), device=device, trace=rec)
    if trace:
        _annotate(eng)
    return params, signs, eng, rec


def warm_open(client: "Client", cell: Cell, cfg, seed: int) -> None:
    """Serve one request of the mix's longest prompt to its end: the
    decode graph is captured and the largest prefill's memory is in the
    allocator before the arrival clock starts."""
    tr = cell.traffic
    rng = np.random.default_rng([seed, 1])
    warm = traffic_mod.RequestSpec(
        -1, rng.integers(0, cfg.vocab_size, int(tr["prompt"]["hi"])),
        tr["engine"]["chunk"] + 1, None)
    client.specs[-1] = warm
    client.submit(warm)
    while client.eng.has_work:
        client.step()
    client.forget(-1)
    client.specs.pop(-1)
    client.steps.clear()


def _annotate(eng) -> None:
    """Host ranges for the profiler around the engine's admission and
    decode chunk (labels for the device's idle gaps)."""
    for attr, label in (("_admit", "engine.admit"),
                        ("_decode_chunk", "decode.chunk")):
        fn = getattr(eng, attr, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _label=label, **k):
            with torch.profiler.record_function(_label):
                return _fn(*a, **k)

        setattr(eng, attr, wrapped)


class Client:
    """Drives the engine and keeps what each stream was handed."""

    def __init__(self, eng, specs, annotate: bool):
        from repro_torch.launch.batch_engine import Request

        self.Request = Request
        self.eng = eng
        self.specs = {s.rid: s for s in specs}
        self.annotate = annotate
        self.served = collections.defaultdict(list)
        self.deliveries = collections.defaultdict(list)
        self.first: dict[int, float] = {}
        self.done: dict[int, float] = {}
        self.steps: list[dict] = []

    def submit(self, s) -> None:
        self.eng.submit(self.Request(rid=s.rid, prompt=s.prompt,
                                     max_new_tokens=s.max_new))

    def step(self) -> float:
        t0 = time.perf_counter()
        if self.annotate:
            with torch.profiler.record_function("engine.step"):
                events, comps = self.eng.step()
        else:
            events, comps = self.eng.step()
        t = time.perf_counter()
        got: dict[int, list] = {}
        for rid, toks in events:
            got.setdefault(rid, []).extend(int(x) for x in toks)
        rec = {"t0": t0, "t1": t, "admitted": [], "decoded": []}
        for rid, toks in got.items():
            if not toks:
                continue
            j0 = len(self.served[rid])
            if j0 == 0:
                rec["admitted"].append(rid)
                self.first[rid] = t
            rec["decoded"].append((rid, j0, len(toks)))
            self.served[rid].extend(toks)
            self.deliveries[rid].append((t, len(toks)))
        for c in comps:
            self.done[c.rid] = t
        self.steps.append(rec)
        return t

    def forget(self, rid: int) -> None:
        for d in (self.served, self.deliveries, self.first, self.done):
            d.pop(rid, None)


def offer(client: Client, order: list, due: dict, nxt: int) -> tuple[int, bool]:
    """The open loop's turn between steps: submit every request of
    ``order`` (sorted by due time) from index ``nxt`` on that is due by
    now; when the engine then has no work, sleep until the next is due
    (at most 10 ms).  Returns the next index and whether to step."""
    now = time.perf_counter()
    while nxt < len(order) and due[order[nxt].rid] <= now:
        client.submit(order[nxt])
        nxt += 1
    if client.eng.has_work:
        return nxt, True
    if nxt < len(order):
        time.sleep(max(0.0, min(due[order[nxt].rid] - now, 0.01)))
    return nxt, False


def _spans(rec) -> list[dict]:
    """The recorder's complete events, on the perf_counter clock."""
    out = []
    for ev in rec.export()["traceEvents"]:
        if ev.get("ph") == "X":
            t0 = rec.t0 + ev["ts"] / 1e6
            out.append({"name": ev["name"], "t0": t0,
                        "t1": t0 + ev["dur"] / 1e6,
                        "args": ev.get("args", {})})
    return out


def _attach_spans(steps: list[dict], spans: list[dict]) -> None:
    """Give each client step its engine.step and decode.chunk spans."""
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s["name"]].append(s)
    for name in by_name:
        by_name[name].sort(key=lambda s: s["t0"])
    for rec in steps:
        for name, key in (("engine.step", "engine_step"),
                          ("decode.chunk", "decode_chunk")):
            inside = [s for s in by_name[name]
                      if rec["t0"] <= s["t0"] and s["t1"] <= rec["t1"]]
            rec[key] = inside[0] if inside else None


def _sample(rng, candidates: list[int], key, k: int) -> list[int]:
    """k of ``candidates``: the largest by ``key``, the rest drawn."""
    if not candidates:
        return []
    top = max(candidates, key=key)
    rest = [c for c in candidates if c != top]
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)),
                      replace=False) if rest and k > 1 else []
    return [top] + [rest[i] for i in sorted(pick)]


def check_streams(ref: Reference, client: Client, rids: list[int], device,
                  control: Optional[Reference] = None
                  ) -> tuple[float, int, Optional[float]]:
    """Widest gap over the sampled streams, the tokens compared, and, given
    a ``control``, the widest gap of the tokens the control puts first at
    the same positions."""
    worst, n, worst_ctl = 0.0, 0, None
    for rid in rids:
        served = client.served[rid]
        prompt = client.specs[rid].prompt
        toks = torch.as_tensor(np.concatenate([prompt, served[:-1]]),
                               device=device)
        logits = ref.logits(toks, len(prompt))
        g = gaps(logits, torch.as_tensor(served, device=device))
        worst = max(worst, float(g.max()))
        n += len(served)
        if control is not None:
            ctl = control.logits(toks, len(prompt))
            w = float(control_gaps(logits, ctl).max())
            worst_ctl = w if worst_ctl is None else max(worst_ctl, w)
            del ctl
        del logits
    return worst, n, worst_ctl


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda",
             t_start: Optional[float] = None, log=None,
             control: bool = False) -> dict:
    """One run of ``workload`` (see the module docstring).  ``control``
    also scores the fp8 control on the same sample (``out["control"]``):
    the limits' upper readings, never part of a benchmark run."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = resolve(Path(root), workload)
    tr = cell.traffic
    cfg = model_config(cell.config)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # ------------------------------------------------------------ set-up
    params, signs, eng, rec = build(cell, cfg, seed, device, trace)
    specs = traffic_mod.make_requests(tr, cfg.vocab_size, seed,
                                      s_max=eng.s_max, seconds=seconds)
    client = Client(eng, specs, annotate=trace)
    due: dict[int, float] = {}
    if tr["kind"] == "closed":
        for s in specs:
            client.submit(s)
        while eng.pending:
            client.step()
        for _ in range(tr.get("warmup_steps", 0)):
            client.step()
        if on_card:
            torch.cuda.synchronize()
        t_open = time.perf_counter()
    else:
        warm_open(client, cell, cfg, seed)
        t0 = time.perf_counter()
        due = {s.rid: t0 + s.due for s in specs}
        t_open = t0 + tr["warmup_s"]
    setup_s = t_open - t_start
    log(f"[perfbench] {workload} seed {seed}: set-up {setup_s:.1f} s")

    # ------------------------------------------------------------ window
    deadline = t_open + seconds
    order = sorted(specs, key=lambda s: s.due or 0.0)
    nxt = 0
    n_prof = tr.get("profile", {}).get("steps", 0) if trace else 0
    stretch = None
    n_stretch = 0
    stretch_rows: list[list[int]] = []
    k_window = 0
    t_close = drain_until = None
    pool_close = lengths_close = None
    while True:
        if due:
            nxt, ready = offer(client, order, due, nxt)
            if not ready:
                if nxt < len(order):
                    continue
                raise RuntimeError("the schedule ran out of requests")
        profiling = t_close is not None and n_stretch < n_prof
        if profiling:
            # the first steps after the close, under the profiler
            if stretch is None:
                stretch = profile.Stretch(ANNOTATIONS)
                stretch.__enter__()
            base = {rid: len(client.specs[rid].prompt)
                    + len(client.served[rid]) - 1
                    for rid in client.first if rid not in client.done}
        t = client.step()
        if profiling:
            n_stretch += 1
            for rid, j0, k in client.steps[-1]["decoded"]:
                if rid in base and j0 > 0:
                    for i in range(k):
                        while len(stretch_rows) <= i:
                            stretch_rows.append([])
                        stretch_rows[i].append(base[rid] + i + 1)
            if n_stretch == n_prof:
                stretch.__exit__(None, None, None)
        if t_close is None:
            k_window += 1
            # a closed mix whose sessions have all ended closes early
            if t >= deadline or (not due and not eng.has_work):
                t_close = t
                pool_close = eng.pool_stats()
                # a retired row's length is reset to 0: the sum is the
                # tokens the live rows hold
                lengths_close = eng.cache["attn"][0].length.tolist()
                mem_peak = (torch.cuda.max_memory_allocated() if on_card
                            else 0)
                drain_until = t + tr.get("drain_s", 0.0)
        if t_close is not None and n_stretch >= n_prof:
            waiting = [r for r, td in due.items()
                       if t_open < td <= t_close and r not in client.first]
            if not waiting or t >= drain_until:
                break
        if t_close is not None and not eng.has_work and not due:
            break
    if stretch is not None and stretch.trace is None:
        stretch.__exit__(None, None, None)
    log(f"[perfbench] window {t_close - t_open:.2f} s, "
        f"{k_window} steps")

    # ------------------------------------------------------ the readings
    spans = _spans(rec) if trace else []
    _attach_spans(client.steps, spans)
    prof = profile.reduce(stretch.trace) if stretch is not None else None
    plen = {rid: len(s.prompt) for rid, s in client.specs.items()}
    in_win_due = [r for r, td in due.items() if t_open < td <= t_close]
    if tr["kind"] == "closed":
        attempted = len(specs)
        failed = sum(1 for s in specs if s.rid not in client.first)
    else:
        attempted = len(in_win_due)
        failed = sum(1 for r in in_win_due if r not in client.first)
        failed += sum(1 for r in client.done
                      if len(client.served[r]) != client.specs[r].max_new)
    ctx = Ctx(cfg=cfg, t_open=t_open,
              t_close=t_close, setup_s=setup_s,
              deliveries=dict(client.deliveries), first=dict(client.first),
              due=due, prompt_len=plen,
              steps=[s for s in client.steps
                     if t_open <= s["t0"] and s["t1"] <= t_close],
              trace=prof, stretch_rows=stretch_rows, pool=pool_close,
              kv_tokens=int(np.asarray(lengths_close).sum()),
              memory_peak_bytes=int(mem_peak))

    # -------------------------------------------- free, then the check
    eng.cancel_all()
    client.eng = None
    del eng
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    rng = np.random.default_rng([seed, 2])
    k = int(cell.check["sample"])
    if tr["kind"] == "closed":
        cands = [s.rid for s in specs if s.rid in client.first]
        rids = _sample(rng, cands, lambda r: plen[r], k)
    else:
        cands = sorted(r for r in client.done if r >= 0)
        rids = _sample(rng, cands,
                       lambda r: plen[r] + len(client.served[r]), k)
    t_ref = time.perf_counter()
    hyper = hyper_from_config(cell.config)
    ref = Reference(hyper, params, signs)
    ctl = Reference(hyper, params, signs, gemm="fp8") if control else None
    worst, n_cmp, worst_ctl = check_streams(ref, client, rids, device, ctl)
    log(f"[perfbench] reference: {len(rids)} streams, {n_cmp} tokens, "
        f"{time.perf_counter() - t_ref:.1f} s")
    limit = float(cell.check["widest_gap"]["limit"])
    correct = bool(failed == 0 and rids and worst <= limit)

    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        v = load_reader(cell.bench, m["name"])(ctx)
        if v is None:
            if not trace and on_card:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": int(mem_peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if prof is not None:
        device_info["busy_s"] = prof["busy_s"]
        device_info["window_s"] = prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    if control:
        out["control"] = {"widest_gap": worst_ctl}
    out["compared"] = {
        "widest_gap": {"value": worst, "limit": limit},
        "failed": {"value": failed, "limit": 0},
        "streams_checked": {"value": len(rids), "limit": 1}}
    return out


@dataclasses.dataclass
class Ctx:
    """What a metric reader reads: the window's client-side record (host
    clock), the engine's spans per step (traced runs), the profiled
    stretch that follows the close (traced runs) and the state at the
    window's close."""

    cfg: object
    t_open: float
    t_close: float
    setup_s: float
    deliveries: dict  # rid -> [(time, n_tokens)]
    first: dict  # rid -> time of its first delivery
    due: dict  # rid -> due time (open mixes)
    prompt_len: dict  # rid -> prompt tokens
    steps: list  # the window's steps: t0, t1, admitted, decoded, spans
    trace: Optional[dict]  # profile.reduce of the stretch after the close
    stretch_rows: list  # cache lengths of each decode step of the stretch
    pool: Optional[dict]  # pool_stats() at the close
    kv_tokens: int  # tokens the live rows hold at the close
    memory_peak_bytes: int

    def span_steps(self) -> list:
        """The window's steps that have their spans (traced runs)."""
        return [s for s in self.steps if s.get("engine_step") is not None]
