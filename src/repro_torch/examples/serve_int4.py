"""End-to-end serving example: batched requests against the int4 cache
(port of ``examples/serve_int4.py``).

    python -m repro_torch.examples.serve_int4 [--device cpu] [--steps N]

A small trained LM (smol-d64, ``--steps`` Adam steps, 80 by default)
serves a batch of requests of one prompt length, with

  * per-channel lambda calibrated from one forward pass over the prompts
    (``launch.serve.calibrate_lambdas``, §7.1), embedded into the cache;
  * the fused rotate+quantize write (kernel B3) filling an int4 +
    residual-window cache (§7.2);
  * rotated-space decode attention, each step one CUDA graph replay on a
    card;
  * the memory ratio against bf16 and each request's continuation.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card and
without that flag it raises.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.launch.engine import Engine
from repro_torch.launch.serve import calibrate_lambdas
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.lm import LM

__all__ = ["main"]

BATCH, PROMPT, NEW = 4, 48, 24


def main(argv: Optional[list[str]] = None) -> dict:
    """Run the example; returns the compression ratio, the timings and
    the continuations it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model = LM(get_config("smol-d64"), device=dev)
    params, opt = init_train_state(model, model.generator(0))

    # quick fit so the continuations are non-trivial
    it = DataIterator(SyntheticCorpus(0), batch_per_shard=8, seq_len=128,
                      device=dev)
    step = make_train_step(model, lr=3e-3)
    for _ in range(args.steps):
        params, opt, _ = step(params, opt, it.next())

    # a batch of requests (synthetic prompts of different origins)
    prompt = torch.cat([
        DataIterator(SyntheticCorpus(10 + i), batch_per_shard=1,
                     seq_len=PROMPT, device=dev).next()["tokens"]
        for i in range(BATCH)])

    with torch.inference_mode():
        # calibrate per-channel lambda: one forward pass over the prompts;
        # the calibrated rotations live in the int4 cache state, so the
        # serving loop below never sees them again
        rots = model.init_rotations(torch.Generator().manual_seed(7))
        t0 = time.time()
        rots = calibrate_lambdas(model, params, prompt, rots)
        t_cal = time.time() - t0
        print(f"[calibrate] lambda in {t_cal:.2f}s (paper: ~2 s per model)")

        pol = model.cache_policy("int4-srft")
        W = pol.window
        s_max = PROMPT + NEW + (W - (PROMPT + NEW) % W) % W
        cache = model.init_cache(BATCH, s_max, policy=pol, rots=rots,
                                 ragged=True)
        bpol = model.cache_policy("bf16")
        bf16 = model.init_cache(BATCH, s_max, policy=bpol)
        n_bf16 = sum(bpol.nbytes(st) for st in bf16["attn"])
        n_int4 = sum(pol.nbytes(st) for st in cache["attn"])
        ratio = pol.compression_ratio(cache["attn"][0])
        print(f"[memory] persistent KV: bf16 {n_bf16 / 1e3:.1f} KB -> int4 "
              f"{n_int4 / 1e3:.1f} KB ({ratio:.2f}x, via the policy API)")

        engine = Engine(model)
        t0 = time.time()
        logits, cache = engine.prefill(params, prompt, cache)
        tok = logits[:, -1].argmax(-1)[:, None]
        float(logits[0, -1, 0])  # the prefill's readback
        t_prefill = time.time() - t0
        t0 = time.time()
        rest, cache = engine.decode(params, tok, cache, NEW - 1)
        gen = torch.cat([tok, rest], dim=1).cpu()
        dt = time.time() - t0

    how = ("one CUDA graph replay a step, first capture included"
           if engine.graph else "eager steps")
    print(f"[serve] {BATCH} requests on {dev}: prefill "
          f"{t_prefill * 1e3:.0f} ms, then {NEW - 1} tokens in {dt:.2f}s "
          f"({how})")
    texts = []
    for i in range(BATCH):
        text = "".join(chr(c) if 32 <= c < 127 else "?"
                       for c in gen[i].tolist())
        texts.append(text)
        print(f"  req[{i}]: ...{text!r}")
    return dict(compression=ratio, calibrate_s=t_cal,
                prefill_ms=t_prefill * 1e3, decode_s=dt,
                tokens=gen.tolist(), texts=texts)


if __name__ == "__main__":
    main()
    sys.exit(0)
