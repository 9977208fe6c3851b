"""B3's and B4's time on the card, revision against revision.

    python -m repro_torch.benchmarks.srft_quant_parts [SOURCE.cu ...]

Builds each source (default: the package's ``csrc/srft_quant.cu``; another
revision of it, say a parent commit's, to compare) with the package's
``nvcc`` flags, binds it in place of the package's library, and runs B3
and B4 at ``chip_smoke.py``'s shapes on random inputs from a seed: B3's
prefill write (32,640 and 4,096 rows x d 128, bf16, rotation matrix and
lambda), B3 without a matrix (the W-flush's 128 rows and the batch ring's
512, fp32), and B4 on int4 codes of 32,640 rows.  Per source, round and
shape: device ms per call by CUDA events (L2 flushed and a spin kernel
ahead of each call, ``decode_read_parts.event_ms``) and how far the
outputs are from the first source's (codes that differ, largest scale or
value difference).  Sources run in turns, ``ROUNDS`` times.  One JSON
line per source and round.  Needs a card.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.benchmarks.decode_read_parts import build, event_ms, use
from repro_torch.core.transforms import make_rotation
from repro_torch.kernels import _build
from repro_torch.kernels.srft_quant import ops
from repro_torch.kernels.srft_quant import ref

ROUNDS = 3
D, GROUP = 128, 32


def inputs(seed: int = 0) -> dict:
    """{shape name: call} at chip_smoke's B3/B4 shapes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rot = make_rotation("srft", g, D, "cuda")
    rot.lam = torch.exp(0.3 * torch.randn(D, generator=g, device="cuda"))

    def x(n, dtype):
        return torch.randn((n, D), generator=g, device="cuda").to(dtype)

    calls = {}
    for n in (32640, 4096):
        xb = x(n, torch.bfloat16)
        calls[f"B3 {n} bf16"] = (lambda xb=xb: ops.srft_quant(
            xb, rot.matrix, rot.lam, group=GROUP))
    for n in (128, 512):
        xf = x(n, torch.float32)
        calls[f"B3 {n} no matrix"] = (lambda xf=xf: ops.srft_quant(
            xf, None, group=GROUP))
    pk, sc = ref.srft_quant_ref(x(32640, torch.float32),
                                ref.fold_matrix(rot), group=GROUP)
    minv = ref.fold_inverse_matrix(rot)
    calls["B4 32640 int4"] = lambda: ops.srft_dequant(pk, sc, minv,
                                                      group=GROUP)
    return calls


def distance(out, first) -> dict:
    if isinstance(out, tuple):  # B3: (codes, scales)
        return {"codes_differ": int((out[0] != first[0]).sum()),
                "max_scale_diff": (out[1] - first[1]).abs().max().item()}
    return {"max_abs_diff": (out - first).abs().max().item()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*",
                    default=[str(_build.CSRC / "srft_quant.cu")])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("srft_quant_parts: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = [build(s) for s in args.sources]
    flush_buf = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    flush = lambda: torch.bitwise_not(flush_buf, out=flush_buf)  # noqa
    calls, first = inputs(), {}
    for rnd in range(ROUNDS):
        for src, lib in zip(args.sources, libs):
            use(lib, "srft_quant")
            rec = {"round": rnd, "source": src,
                   "card": torch.cuda.get_device_name(0)}
            for name, fn in calls.items():
                out = fn()
                torch.cuda.synchronize()
                rec[name] = {"ms": event_ms(fn, flush),
                             **distance(out, first.setdefault(name, out))}
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
