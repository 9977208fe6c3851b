"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi); TF32 off;
  2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
  3. hold each kernel against its plain PyTorch version on the card at
     the shapes the main path gives it, and time both;
  4. check the served model against the port's plain CPU path on a small
     input;
  5. the main path: internlm2-1.8b at full width and depth, random weights
     from a seed, bf16-operand / fp32-accumulate dots, answering requests
     of 517, 2055 and 4093 prompt tokens (64 new tokens each) through the
     int4-srft cache (KERNEL read) and, as context, the bf16 cache; the
     kernels' launch counters are zeroed just before and read just after;
  6. one request again under the GATHER read, held against KERNEL.
Prints one JSON line describing every kernel, then, last, the line
``{"ok": true, "device": {...}}``.  Needs CUDA: without a card it exits
non-zero before building anything.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PROMPTS = (517, 2055, 4093)
NEW_TOKENS = 64
S_MAX = 4608
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (data sheet)
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
LOGIT_TOL = 0.05  # GATHER vs KERNEL, relative to the largest logit
B1_ATOL = 1e-4  # fp32 sums in another order (split-K) over ~4K tokens
TIE_BAND = 1e-4  # B3 codes may flip by 1 only this close to a .5 boundary
MAX_FLIP_SHARE = 1e-3


def log(*a):
    print(*a, flush=True)


def require_card():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device visible; this script runs on the card")
        sys.exit(2)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing

class L2Flush:
    """Rewrite a buffer larger than the 50 MB L2 before each timed call: on
    the main path each layer's cache is read cold.  Its kernel
    (bitwise_not) is left out of the device sums."""

    NAME = "bitwise_not"

    def __init__(self):
        self.buf = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self):
        torch.bitwise_not(self.buf, out=self.buf)


def _kernel_us(prof, skip=()) -> dict:
    """Device microseconds by kernel name from a torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or any(k in e.key for k in skip):
            continue
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t:
            out[e.key] = out.get(e.key, 0.0) + t
    return out


def device_ms(fn, flush, iters=20, warmup=3) -> float:
    """Device time of one call: the sum of the durations of the CUDA
    kernels it launches (torch.profiler), L2 flushed before each call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            fn()
        torch.cuda.synchronize()
    total = sum(_kernel_us(prof, skip=(L2Flush.NAME,)).values())
    assert total > 0, "the profiler recorded no device time"
    return total / iters / 1e3


def wall_ms(fn, iters=50) -> float:
    """Time per call of back-to-back calls (CUDA events): bounded by the
    host's launch overhead when that exceeds the kernels' time."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels

def check_b3(sq_ops, ref, rot, x, *, group):
    """Kernel vs plain on the same inputs: scales rtol 1e-6, codes equal
    except +-1 flips at .5 ties of y/scale (float64 y)."""
    from repro_torch.core import packing

    mat = None if rot is None else rot.matrix
    lam = None if rot is None else rot.lam
    kp, ks = sq_ops.srft_quant(x, mat, lam, group=group)
    rp, rs = ref.srft_quant_ref(x, mat, lam, group=group)
    torch.cuda.synchronize()
    torch.testing.assert_close(ks, rs, rtol=1e-6, atol=0)
    ck = packing.unpack_int4(kp).int()
    cr = packing.unpack_int4(rp).int()
    diff = ck - cr
    y = x.double() if mat is None else x.double() @ mat.double().T
    if lam is not None:
        y = y * lam.double()
    ratio = y / rs.double().repeat_interleave(group, dim=-1)
    near_tie = ((ratio.abs() % 1.0) - 0.5).abs() < TIE_BAND
    flips = diff != 0
    assert int(diff.abs().max()) <= 1, "B3 code off by more than 1"
    assert not bool((flips & ~near_tie).any()), "B3 code flipped off a tie"
    share = flips.float().mean().item()
    assert share <= MAX_FLIP_SHARE, f"B3 flip share {share}"
    deq = lambda c, s: (c.float().reshape(*c.shape[:-1], -1, group)  # noqa
                        * s[..., None]).reshape(c.shape)
    err = (deq(ck, ks) - deq(cr, rs)).abs().max().item()
    return err, int(flips.sum())


def kernel_phase(flush):
    from repro_torch.core.transforms import make_rotation
    from repro_torch.kernels.quant_attention import ops as qa_ops
    from repro_torch.kernels.quant_attention import ref as qa_ref
    from repro_torch.kernels.srft_quant import ops as sq_ops
    from repro_torch.kernels.srft_quant import ref as sq_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    d, group, Hkv, G, W = 128, 32, 8, 2, 16
    rot = make_rotation("srft", g, d, "cuda")
    rot.lam = torch.exp(0.3 * torch.randn(d, generator=g, device="cuda"))
    out = []

    # B3, prefill bulk of the longest prompt: (4093 // W * W) * Hkv rows
    n = (PROMPTS[-1] // W) * W * Hkv
    x = torch.randn((n, d), generator=g, device="cuda").to(torch.bfloat16)
    err, flips = check_b3(sq_ops, sq_ref, rot, x, group=group)
    log(f"B3 prefill write n={n} d={d} bf16 in: max |deq diff| {err:.3e} "
        f"({flips} tie flips, share <= {MAX_FLIP_SHARE}), scales rtol 1e-6")
    call = lambda: sq_ops.srft_quant(x, rot.matrix, rot.lam,  # noqa: E731
                                     group=group)
    ms, ms_wall = device_ms(call, flush), wall_ms(call)
    plain = device_ms(lambda: sq_ref.srft_quant_ref(
        x, rot.matrix, rot.lam, group=group), flush)
    nbytes = n * d * 2 + d * d * 4 + d * 4 + n * d // 2 + n * d // group * 4
    b_ms, b_by = bound(nbytes, 2.0 * n * d * d)
    b3 = dict(name="srft_quant", route="cuda",
              source="src/repro_torch/kernels/csrc/srft_quant.cu",
              replaces="src/repro/kernels/srft_quant/srft_quant.py:91",
              max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
              bound_by=b_by, library_ms=None, wall_ms=ms_wall)
    # B3 flush mode: one W-window of K (already rotated, fp32)
    xf = torch.randn((Hkv * W, d), generator=g, device="cuda")
    err_f, _ = check_b3(sq_ops, sq_ref, None, xf, group=group)
    ms_f = device_ms(lambda: sq_ops.srft_quant(xf, None, group=group), flush)
    log(f"B3 flush n={Hkv * W}: max |deq diff| {err_f:.3e}, {ms_f:.4f} ms")
    b3["max_abs_err"] = max(err, err_f)
    b3["flush_ms"] = ms_f
    out.append(b3)

    # B1 at the longest request's last decode step
    total = PROMPTS[-1] + NEW_TOKENS - 1
    plen = total - total % W
    BH = Hkv
    q = torch.randn((BH, G, d), generator=g, device="cuda") * 0.1
    kp = torch.randint(0, 256, (BH, S_MAX, d // 2), generator=g,
                       device="cuda", dtype=torch.uint8)
    vp = torch.randint(0, 256, (BH, S_MAX, d // 2), generator=g,
                       device="cuda", dtype=torch.uint8)
    ks = torch.rand((BH, S_MAX, d // group), generator=g, device="cuda") * 0.3
    vs = torch.rand((BH, S_MAX, d // group), generator=g, device="cuda") * 0.3
    kr = torch.randn((BH, W, d), generator=g, device="cuda")
    vr = torch.randn((BH, W, d), generator=g, device="cuda")
    args = (q, kp, ks, vp, vs, kr, vr)
    got = qa_ops.quant_decode_attention(*args, plen, total, group=group)
    want = qa_ref.quant_decode_attention_ref(*args, plen, total, group=group)
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= B1_ATOL, f"B1 err {err}"
    # per-row lengths with an empty row and a tile-edge row
    rows = torch.tensor([0, 64, 65, 1000, plen, 16, 4096, 4500],
                        dtype=torch.int32, device="cuda")
    tl = (rows + torch.tensor([0, 0, 3, 15, total - plen, 1, 16, 7],
                              device="cuda")).int()
    got_r = qa_ops.quant_decode_attention(*args, rows, tl, group=group)
    want_r = qa_ref.quant_decode_attention_ref(*args, rows, tl, group=group)
    err_r = (got_r - want_r).abs().max().item()
    assert torch.isfinite(got_r).all() and err_r <= B1_ATOL, f"B1 rows {err_r}"
    log(f"B1 decode read BH={BH} G={G} d={d} plen={plen} total={total}: "
        f"max abs err {err:.3e} (per-row lengths {err_r:.3e}), "
        f"tolerance {B1_ATOL}")
    call = lambda: qa_ops.quant_decode_attention(  # noqa: E731
        *args, plen, total, group=group)
    ms, ms_wall = device_ms(call, flush), wall_ms(call)
    plain = device_ms(lambda: qa_ref.quant_decode_attention_ref(
        *args, plen, total, group=group), flush)
    nbytes = (BH * G * d * 4 * 2 + 2 * BH * plen * (d // 2 + d // group * 4)
              + 2 * BH * W * d * 4)
    b_ms, b_by = bound(nbytes, 4.0 * BH * G * d * (plen + W))
    # context only: a bf16 SDPA read of a bf16 cache of the same length
    qb = torch.randn((1, BH * G, 1, d), device="cuda", dtype=torch.bfloat16)
    kb = torch.randn((1, BH, total, d), device="cuda", dtype=torch.bfloat16)
    sdpa = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kb, kb, enable_gqa=True), flush)
    log(f"context: bf16 SDPA over a {total}-token bf16 cache: {sdpa:.4f} ms")
    out.append(dict(name="quant_decode_attention", route="cuda",
                    source="src/repro_torch/kernels/csrc/quant_attention.cu",
                    replaces="src/repro/kernels/quant_attention/"
                             "quant_attention.py:157",
                    max_abs_err=max(err, err_r), ms=ms, plain_ms=plain,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    wall_ms=ms_wall))
    return out


# ------------------------------------------------------------------ model

def small_reference_phase():
    """The port on the card (kernels) against the port on the CPU (plain
    versions, themselves held against the JAX reference by the tests), on
    a small internlm2-shaped model."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.engine import Engine
    from repro_torch.models.lm import LM

    cfg = reduced(get_config("internlm2-1.8b"))
    cpu = LM(cfg, device="cpu")
    params = cpu.init(cpu.generator(SEED))
    gpu = LM(cfg, device="cuda")
    params_gpu = _to(params, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, 37),
                           generator=torch.Generator().manual_seed(SEED))
    res = {}
    for name, model, p in (("cpu", cpu, params), ("cuda", gpu, params_gpu)):
        cache = model.init_cache(1, 96, policy="int4-srft",
                                 generator=torch.Generator().manual_seed(5))
        res[name] = Engine(model, backend="kernel").generate(
            p, prompt.to(model.device), cache, 24, return_logits=True)
    lc, lg = res["cpu"][1], res["cuda"][1].cpu()
    assert lg.shape == (1, 24, cfg.vocab_size) and torch.isfinite(lg).all()
    tc, tg = res["cpu"][0], res["cuda"][0].cpu()
    n_same = _agree_until(tc, tg, lc)
    err = (lc[:, :n_same] - lg[:, :n_same]).abs().max().item()
    tol = LOGIT_TOL * lc.abs().max().item()
    assert err <= tol, f"small model: card vs CPU logits {err} > {tol}"
    log(f"small model (reduced internlm2, 37+24 tokens): card vs CPU plain "
        f"max logit err {err:.3e} (tol {tol:.3e}), tokens agree for "
        f"{n_same}/24 steps")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _agree_until(t_ref, t_got, l_ref) -> int:
    """Steps whose logits may be compared: all if the greedy tokens agree,
    else up to the first divergence, which must be a near-tie."""
    diff = (t_ref != t_got).nonzero()
    if not len(diff):
        return t_ref.shape[1]
    b, i = diff[diff[:, 1].argmin()].tolist()
    top2 = l_ref[b, i].topk(2).values
    gap = (top2[0] - top2[1]).item()
    tol = LOGIT_TOL * l_ref.abs().max().item()
    assert gap < tol, f"tokens diverge at step {i} with top-2 gap {gap}"
    log(f"  near-tie divergence at step {i} (top-2 gap {gap:.3e})")
    return i + 1


def serve(model, params, policy, backend, prompt_len):
    from repro_torch.launch.engine import Engine

    g = torch.Generator(device="cuda").manual_seed(SEED + prompt_len)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, prompt_len),
                           generator=g, device="cuda")
    cache = model.init_cache(1, S_MAX, policy=policy,
                             generator=torch.Generator().manual_seed(SEED))
    eng = Engine(model, backend=backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = eng.prefill(params, prompt, cache)
    tok = lg[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, step_logits, cache = eng.decode(params, tok, cache, NEW_TOKENS - 1,
                                          return_logits=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    toks = torch.cat([tok, toks], dim=1)
    all_logits = torch.cat([lg[:, -1:].float(), step_logits], dim=1)
    assert toks.shape == (1, NEW_TOKENS)
    assert all_logits.shape == (1, NEW_TOKENS, model.cfg.vocab_size)
    assert torch.isfinite(all_logits).all(), "non-finite logits"
    assert cache["pos"] == prompt_len + NEW_TOKENS - 1
    assert all(c.length == cache["pos"] for c in cache["attn"])
    attn = cache["attn"]
    row = dict(policy=policy, backend=backend or "gather", prompt=prompt_len,
               prefill_ms=(t1 - t0) * 1e3,
               decode_ms_per_tok=(t2 - t1) * 1e3 / (NEW_TOKENS - 1),
               cache_bytes=sum(c.nbytes() for c in attn),
               compression=attn[0].policy.compression_ratio(attn[0]))
    return row, toks, all_logits


def profile_decode(model, params, policy, backend, prompt_len, steps=4):
    """Decode steps of one request under torch.profiler: wall ms per step
    (host clock, inflated by the profiler), device-busy ms per step (sum of
    kernel durations), the device's idle share, and the kernels that take
    the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.engine import Engine

    g = torch.Generator(device="cuda").manual_seed(SEED + prompt_len)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, prompt_len),
                           generator=g, device="cuda")
    cache = model.init_cache(1, S_MAX, policy=policy,
                             generator=torch.Generator().manual_seed(SEED))
    eng = Engine(model, backend=backend)
    lg, cache = eng.prefill(params, prompt, cache)
    toks, cache = eng.decode(params, lg[:, -1].argmax(-1)[:, None], cache, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decode(params, toks[:, -1:], cache, steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    us = _kernel_us(prof)
    busy = sum(us.values()) / 1e3 / steps
    top = sorted(us.items(), key=lambda kv: -kv[1])[:6]
    return dict(policy=policy, backend=backend or "gather",
                prompt=prompt_len, wall_ms_per_step=wall,
                device_busy_ms_per_step=busy, idle_share=1 - busy / wall,
                top_kernels_ms_per_step=[(k[:60], v / 1e3 / steps)
                                         for k, v in top])


def main_path_phase():
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_attention import ops as qa_ops
    from repro_torch.kernels.srft_quant import ops as sq_ops
    from repro_torch.models import common
    from repro_torch.models.lm import LM

    assert common.BF16_DOTS, "expected REPRO_BF16_DOTS=1"
    log("dot mode: bf16 operands, fp32 accumulate (REPRO_BF16_DOTS=1)")
    cfg = get_config("internlm2-1.8b")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(model.generator(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f}B params, init {time.perf_counter() - t0:.1f}s")
    # warm-up request (first-call allocations, cuBLAS handles), not counted
    serve(model, params, "int4-srft", "kernel", 64)
    serve(model, params, "bf16", None, 64)

    sq_ops.launches = 0
    qa_ops.launches = 0
    rows, kernel_runs = [], {}
    for n in PROMPTS:
        row, toks, logits = serve(model, params, "int4-srft", "kernel", n)
        rows.append(row)
        kernel_runs[n] = (toks, logits)
    launches = {"srft_quant": sq_ops.launches,
                "quant_decode_attention": qa_ops.launches}
    for n in PROMPTS:
        rows.append(serve(model, params, "bf16", None, n)[0])
    for r in rows:
        log("request " + json.dumps(r))
    log(f"main-path launches: {launches}")
    for name, count in launches.items():
        assert count > 0, f"{name} never launched on the main path"

    n = PROMPTS[1]
    row, toks_g, logits_g = serve(model, params, "int4-srft", "gather", n)
    toks_k, logits_k = kernel_runs[n]
    n_same = _agree_until(toks_k, toks_g, logits_k)
    err = (logits_k[:, :n_same] - logits_g[:, :n_same]).abs().max().item()
    tol = LOGIT_TOL * logits_k.abs().max().item()
    assert err <= tol, f"GATHER vs KERNEL logits {err} > {tol}"
    log(f"GATHER rerun of the {n}-token request: {row['decode_ms_per_tok']:.3f}"
        f" ms/tok; max logit diff vs KERNEL {err:.3e} (tol {tol:.3e}), "
        f"tokens agree for {n_same}/{NEW_TOKENS} steps")
    for policy, backend in (("int4-srft", "kernel"), ("bf16", None)):
        log("decode profile " + json.dumps(profile_decode(
            model, params, policy, backend, PROMPTS[-1])))
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    require_card()
    os.environ["REPRO_BF16_DOTS"] = "1"  # read when repro_torch.models loads
    sys.path.insert(0, str(ROOT / "src"))
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off, "
        f"bf16 reduced-precision reductions off")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    flush = L2Flush()
    kernels = kernel_phase(flush)
    small_reference_phase()
    launches = main_path_phase()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
