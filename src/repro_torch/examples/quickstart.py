"""Quickstart: the paper's technique through the port's public API (port
of ``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu] [--steps N]

1. Build a small GQA transformer (smol-d64: head_dim 64, the paper's
   SmolLM2 regime).
2. Train it briefly (``--steps``, 80 by default) on the synthetic corpus.
3. Round-trip the fused rotate-quantize write (kernel B3) and its inverse
   (kernel B4) standalone, held against their plain versions (on a CPU
   tensor the wrappers run the plain versions themselves).
4. Serve greedy decode under the three registered cache policies (bf16,
   SRFT int4, int8 per token) and print each one's compression ratio.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card and
without that flag it raises.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.transforms import make_rotation
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.kernels.srft_quant import ops, ref
from repro_torch.launch.engine import generate
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.lm import LM

__all__ = ["main", "POLICIES"]

POLICIES = ("bf16", "int4-srft", "int8-per-token")


def _text(tokens) -> str:
    return "".join(chr(c) if 32 <= c < 127 else "?" for c in tokens)


def main(argv: Optional[list[str]] = None) -> dict:
    """Run the quickstart; returns what it printed as a dict: the losses,
    the kernels' round trip and agreement with their plain versions, and
    each policy's compression ratio and continuation."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out: dict = {"device": str(dev)}

    # --- 1. model ---------------------------------------------------------
    cfg = get_config("smol-d64")
    model = LM(cfg, device=dev)
    params, opt = init_train_state(model, model.generator(0))
    print(f"model: {cfg.name} ({cfg.n_layers}L d={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim}) "
          f"on {dev}")

    # --- 2. short training run --------------------------------------------
    it = DataIterator(SyntheticCorpus(0), batch_per_shard=8, seq_len=128,
                      device=dev)
    step = make_train_step(model, lr=3e-3)
    losses = []
    for i in range(args.steps):
        params, opt, m = step(params, opt, it.next())
        losses.append(m["loss"])
        if (i + 1) % 20 == 0 or i + 1 == args.steps:
            print(f"  train step {i + 1}: loss {float(m['loss']):.3f}")
    out["losses"] = torch.stack(losses).tolist() if losses else []

    # --- 3. the fused kernels, standalone ----------------------------------
    with torch.inference_mode():
        rot = make_rotation("srft", torch.Generator().manual_seed(1),
                            cfg.head_dim, dev)
        x = torch.randn((256, cfg.head_dim),
                        generator=torch.Generator().manual_seed(2)).to(dev)
        packed, scales = ops.rotate_quantize(x, rot, group=32, bits=4)
        x_hat = ops.dequantize_rotate(packed, scales, rot, group=32, bits=4)
        size_in = x.numel() * x.element_size()
        size_q = packed.numel() + scales.numel() * scales.element_size()
        rt = float((x - x_hat).norm() / x.norm())
        pr, sr = ref.srft_quant_ref(x, rot.matrix, rot.lam, group=32, bits=4)
        x_ref = ref.srft_dequant_ref(packed, scales,
                                     ref.fold_inverse_matrix(rot), group=32,
                                     bits=4)
        same = float((packed == pr).float().mean())
        b4_err = float((x_hat - x_ref).abs().max())
    print(f"kernel: {size_in} B fp32 -> {size_q} B int4+scales "
          f"({size_in / size_q:.2f}x), rel rt err {rt:.4f}")
    print(f"kernel vs plain: B3 codes {100 * same:.3f}% bit-identical, "
          f"scales max rel diff "
          f"{float(((scales - sr).abs() / sr.abs()).max()):.2e}; B4 max abs "
          f"diff {b4_err:.2e}")
    out["kernel"] = dict(ratio=size_in / size_q, rt_err=rt,
                         b3_code_agreement=same, b4_max_abs_diff=b4_err)

    # --- 4. serve under three registered cache policies -------------------
    # the model code never branches on the cache type: each policy owns its
    # state (rotations included) and its read
    prompt = DataIterator(SyntheticCorpus(1), batch_per_shard=2, seq_len=48,
                          device=dev).next()["tokens"][:, :40]
    out["policies"] = {}
    with torch.inference_mode():
        for name in POLICIES:
            cache = model.init_cache(2, 64, policy=name, ragged=True,
                                     generator=torch.Generator()
                                     .manual_seed(7))
            toks, cache = generate(params, prompt, cache, 12, model=model)
            st = cache["attn"][0]
            ratio = st.policy.compression_ratio(st)
            text = _text(toks[0].tolist())
            print(f"  {name:15s} ({ratio:.2f}x KV) continuation: {text!r}")
            out["policies"][name] = dict(compression=ratio, text=text,
                                         tokens=toks.tolist())
    print("quickstart done.")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
