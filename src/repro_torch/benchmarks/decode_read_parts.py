"""B1's and B2's time on the card, split into their two kernels.

    python -m repro_torch.benchmarks.decode_read_parts [SOURCE.cu ...]

Builds each source (default: the package's ``csrc/quant_attention.cu``;
another revision of it, say a parent commit's, to compare) with the
package's ``nvcc`` flags, binds it in place of the package's library, and
runs the two reads at ``chip_smoke.py``'s shapes -- B1 at batch 1 (8 kv
heads, G 2, d 128, group 32, 4144 packed tokens of 4608) and B2 over rows
of 517 / 1031 / 2055 / 4093 / 0 tokens x 8 heads, page size 16, pages
shuffled -- and B2 at one layer of the benchmark's long-context cells
(:func:`cell_inputs`: 64 rows at G 2 and 32 at G 5, 8 kv heads each) on
random codes from a seed.  Per source and read: device ms
per call by CUDA events (L2 flushed and a spin kernel ahead of each
call), and each kernel's mean device us per call from ``torch.profiler``
(pass 1 ``qda_split_kernel``, pass 2 ``qda_combine_kernel``; a mean stays
right where the profiler drops records), and the largest difference from
the first source's output.  Sources run in turns, ``ROUNDS`` times.
One JSON line per source and round.  Needs a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import json
import math
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_attention import ops
from repro_torch.kernels.srft_quant import ops as sq_ops

SPIN_CYCLES = 2_000_000  # ~1 ms at 1980 MHz: the host queues the call ahead
ROUNDS = 2
# one layer of the benchmark's long-context cells: (sessions, query heads
# per kv head); 8 kv heads, d 128, group 32, pages of 16, s_max 16384
CELLS = {"internlm2-longctx-decode": (64, 2),
         "qwen3-14b-longctx-decode": (32, 5)}
CELL_DECODED = 1024  # tokens each session has decoded past its prompt


def build(source: str) -> str:
    """Compile ``source`` as the package compiles its own; the library path."""
    text = open(source, "rb").read()
    digest = hashlib.sha256(text + " ".join(_build.NVCC_FLAGS).encode())
    path = _build.BUILD_DIR / f"libparts-{digest.hexdigest()[:16]}.so"
    if not path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(path),
                        source], check=True, capture_output=True)
    return str(path)


def use(path: str, source: str = "quant_attention") -> None:
    """Make the wrappers of ``csrc/<source>.cu`` launch the library at
    ``path``."""
    _build._LIBS[source] = ctypes.CDLL(path)
    {"quant_attention": ops, "srft_quant": sq_ops}[source]._FNS.clear()


def inputs(seed: int = 0) -> dict:
    """{"B1": call, "B2": call} at chip_smoke's shapes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, group, H, G, W, s_max, ps = 128, 32, 8, 2, 16, 4608, 16

    def codes(*shape):
        return torch.randint(0, 256, shape, generator=g, device="cuda",
                             dtype=torch.uint8)

    def scales(*shape):
        return torch.rand(shape, generator=g, device="cuda") * 0.3

    def f(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    total = 4093 + 63
    ng = d // group
    b1 = (f(H, G, d) * 0.1, codes(H, s_max, d // 2), scales(H, s_max, ng),
          codes(H, s_max, d // 2), scales(H, s_max, ng), f(H, W, d),
          f(H, W, d), total - total % W, total)
    lengths = (517, 1031, 2055, 4093, 0)
    need = [-(-n // ps) for n in lengths]
    perm = (torch.randperm(sum(need), generator=torch.Generator()
                           .manual_seed(seed)) + 1).tolist()
    table = torch.zeros((len(lengths), s_max // ps), dtype=torch.int32)
    for b, n in enumerate(need):
        table[b, :n] = torch.tensor([perm.pop() for _ in range(n)])
    N, BH = (sum(need) + 1) * H, len(lengths) * H
    L = torch.tensor(lengths, dtype=torch.int32,
                     device="cuda").repeat_interleave(H)
    b2 = (f(BH, G, d) * 0.1, codes(N, ps, d // 2), scales(N, ps, ng),
          codes(N, ps, d // 2), scales(N, ps, ng), f(BH, W, d), f(BH, W, d),
          (L - L % W).int(), L, table.cuda())
    calls = {"B1": lambda: ops.quant_decode_attention(*b1, group=group),
             "B2": lambda: ops.quant_decode_attention_paged(
                 *b2, group=group, page_size=ps, n_kv_heads=H)}
    for cell in CELLS:
        args, kw, _ = cell_inputs(cell, seed)
        calls[f"B2 {cell}"] = (lambda a=args, k=kw:
                               ops.quant_decode_attention_paged(*a, **k))
    return calls


def cell_lengths(sessions: int, seed: int) -> list[int]:
    """The cells' session lengths: their prompts (the quantile midpoints
    of log-uniform 2048..8192 by 16, in an order drawn from ``seed``) with
    :data:`CELL_DECODED` tokens decoded."""
    u = (torch.arange(sessions, dtype=torch.float64) + 0.5) / sessions
    prompts = (torch.exp(math.log(2048) + u * math.log(4)) / 16).round() * 16
    order = torch.randperm(sessions, generator=torch.Generator()
                           .manual_seed(seed))
    return [int(n) + CELL_DECODED for n in prompts[order]]


def cell_inputs(cell: str, seed: int = 0, device: str = "cuda"):
    """(args, kw, lengths) of one B2 call at a layer of ``cell``
    (:data:`CELLS`): random pools behind a shuffled page table, every row
    mapped to s_max, per-row windows; call as
    ``ops.quant_decode_attention_paged(*args, **kw)``."""
    sessions, G = CELLS[cell]
    H, d, group, W, ps, s_max = 8, 128, 32, 16, 16, 16384
    lengths = cell_lengths(sessions, seed)
    g = torch.Generator(device=device).manual_seed(seed)
    MP = s_max // ps
    need = [-(-n // ps) for n in lengths]
    perm = (torch.randperm(sum(need), generator=torch.Generator()
                           .manual_seed(seed)) + 1).tolist()
    table = torch.zeros((sessions, MP), dtype=torch.int32)
    for b, n in enumerate(need):
        table[b, :n] = torch.tensor([perm.pop() for _ in range(n)])
    N, BH = (sum(need) + 1) * H, sessions * H
    codes = lambda *sh: torch.randint(0, 256, sh, generator=g,  # noqa
                                      device=device, dtype=torch.uint8)
    scales = lambda *sh: torch.rand(sh, generator=g,  # noqa
                                    device=device) * 0.3
    f = lambda *sh: torch.randn(sh, generator=g, device=device)  # noqa
    L = torch.tensor(lengths, dtype=torch.int32,
                     device=device).repeat_interleave(H)
    args = (f(BH, G, d) * 0.1, codes(N, ps, d // 2), scales(N, ps, d // group),
            codes(N, ps, d // 2), scales(N, ps, d // group), f(BH, W, d),
            f(BH, W, d), (L - L % W).int(), L, table.to(device))
    return args, dict(group=group, page_size=ps, n_kv_heads=H), lengths


def event_ms(fn, flush, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def kernel_us(fn, flush, iters: int = 30) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for kind, name in (("pass1_us", "qda_split"),
                           ("pass2_us", "qda_combine")):
            if e.device_type.name == "CUDA" and name in e.key and e.count:
                out[kind] = e.device_time_total / e.count
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*",
                    default=[str(_build.CSRC / "quant_attention.cu")])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_read_parts: needs a CUDA card")
    with concurrent.futures.ThreadPoolExecutor() as pool:  # nvcc at once
        libs = list(pool.map(build, args.sources))
    flush_buf = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    flush = lambda: torch.bitwise_not(flush_buf, out=flush_buf)  # noqa
    calls, first = inputs(), {}
    for rnd in range(ROUNDS):
        for src, lib in zip(args.sources, libs):
            use(lib)
            rec = {"round": rnd, "source": src,
                   "card": torch.cuda.get_device_name(0)}
            for name, fn in calls.items():
                out = fn()
                ref = first.setdefault(name, out)
                rec[name] = {"ms": event_ms(fn, flush),
                             "max_abs_diff": (out - ref).abs().max().item(),
                             **kernel_us(fn, flush)}
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
