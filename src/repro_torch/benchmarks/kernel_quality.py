"""Paper Table 7 and §4.4 Correctness on the port (port of
``benchmarks/kernel_quality.py:33-135``):

  * ``bit_exactness``: the fused write (B3, folded matrix) and its inverse
    (B4) against their plain versions at d in {64, 128, 256} x int4/int8 x
    unscaled / scaled-lambda.  On a CPU tensor the wrappers run the plain
    versions, so the comparison is trivial there; on the card it holds the
    hand-written kernels.  The reference requires exact int4 agreement
    because its kernel and oracle share ``jnp`` ops; on the card the
    d-term rotation sums run in another order than the plain version's, so
    codes are held to the tie rule instead: equal, except +-1 where
    y/scale lies within ``TIE_BAND`` of a .5 boundary (float64 y), at most
    ``MAX_FLIP_SHARE`` of them.  The agreement share is recorded.
  * ``table7_ladder``: Table 7's quality ladder on the trained d=128
    stand-in with one injected K outlier channel (alpha 100): per_token vs
    g32 without lambda vs scaled_g32 (static lambda + per-group), by hook
    ΔPPL.  These are the paper's claims; the record reports whether they
    hold and nothing here gates on them.

    python -m repro_torch.benchmarks.kernel_quality [--device cpu] [--quick]

writes ``artifacts/bench_torch/kernel_quality.json`` and prints its
summary as one JSON line last; exits non-zero if a kernel check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import (
    calibrated_rots,
    eval_tokens,
    fmt_table,
    hook_ppl,
    save_record,
    trained_standin,
)
from repro_torch.core import packing
from repro_torch.core.calibrate import apply_static_lambda
from repro_torch.core.outliers import inject_kv_outliers
from repro_torch.core.transforms import make_rotation
from repro_torch.kernels.srft_quant import ops, ref

__all__ = ["bit_exactness", "fold_and_invert", "table7_ladder", "run",
           "TIE_BAND", "MAX_FLIP_SHARE", "B4_RTOL"]

TIE_BAND = 1e-4  # codes may flip by 1 only this close to a .5 boundary
MAX_FLIP_SHARE = 1e-3  # and at most this share of all codes
SCALE_RTOL = 1e-5  # the reference's "scales_match" bar
B4_RTOL = 1e-5  # B4 vs plain on the same codes: max abs err / max(1, |x|)
GROUP = 32
LADDER = (
    ("per_token", False, dict(bits=4, scheme="per_token", group=GROUP)),
    ("g32_no_lambda", False, dict(bits=4, scheme="per_group", group=GROUP)),
    ("scaled_g32", True, dict(bits=4, scheme="per_channel_group",
                              group=GROUP)),
)


def _codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    return (packing.unpack_int4(packed) if bits == 4 else packed).int()


def fold_and_invert(x: torch.Tensor, rot, *, group: int = GROUP,
                    bits: int = 4) -> dict:
    """The folded write (B3) of ``x`` and its inverse (B4) through
    ``ops.dequantize_rotate``, with B4 held against its plain version on
    the same codes: the codes and scales, ``minv``, both outputs, B4's max
    abs error and its tolerance ``B4_RTOL * max(1, max |x|)``."""
    pk, sk = ops.srft_quant(x, ref.fold_matrix(rot), None, group=group,
                            bits=bits)
    minv = ref.fold_inverse_matrix(rot)
    got = ops.dequantize_rotate(pk, sk, rot, group=group, bits=bits)
    want = ref.srft_dequant_ref(pk, sk, minv, group=group, bits=bits)
    x_max = want.abs().max().item()
    return {"packed": pk, "scales": sk, "minv": minv, "x": got,
            "x_plain": want, "x_max": x_max,
            "err": (got - want).abs().max().item(),
            "tol": B4_RTOL * max(1.0, x_max)}


def bit_exactness(*, n: int = 2048, device=None) -> list[dict]:
    """One row per (d, bits, variant): code agreement, tie flips, scale
    error, B4 against its plain version on the same codes, and the round
    trip through both kernels against the plain round trip."""
    dev = resolve_device(device)
    rows = []
    for d in (64, 128, 256):
        for bits in (4, 8):
            for scaled in (False, True):
                g = torch.Generator(device=dev).manual_seed(d + bits)
                rot = make_rotation("srft", g, d, dev)
                if scaled:
                    rot = apply_static_lambda(rot, torch.exp(0.3 * torch.randn(
                        d, generator=g, device=dev)))
                x = 3.0 * torch.randn((n, d), generator=g, device=dev)
                m = ref.fold_matrix(rot)
                rt = fold_and_invert(x, rot, bits=bits)
                pk, sk = rt["packed"], rt["scales"]
                pr, sr = ref.srft_quant_ref(x, m, None, group=GROUP,
                                            bits=bits)
                diff = _codes(pk, bits) - _codes(pr, bits)
                y = x.double() @ m.double().T
                ratio = y / sr.double().repeat_interleave(GROUP, dim=-1)
                near_tie = ((ratio.abs() % 1.0) - 0.5).abs() < TIE_BAND
                flips = diff != 0
                scale_rel = ((sk - sr).abs()
                             / sr.abs().clamp_min(1e-12)).max().item()
                x_oracle = ref.srft_dequant_ref(pr, sr, rt["minv"],
                                                group=GROUP, bits=bits)
                row = {
                    "d": d, "bits": bits,
                    "variant": "scaled_g32" if scaled else "g32",
                    "int_agreement": 1.0 - flips.float().mean().item(),
                    "tie_flips": int(flips.sum()),
                    "flips_off_tie": int((flips & ~near_tie).sum()),
                    "max_code_diff": int(diff.abs().max()),
                    "scale_rel_err": scale_rel,
                    "b4_vs_plain": rt["err"],
                    "b4_tol": rt["tol"],
                    "kernel_vs_ref_rt": (rt["x"] - x_oracle).abs().max()
                    .item(),
                    "x_max": rt["x_max"],
                }
                rows.append(row)
                print(f"  d={d} b={bits} {row['variant']:10s} "
                      f"agree={row['int_agreement']:.6f} "
                      f"flips={row['tie_flips']} "
                      f"scale_rel={scale_rel:.2e} "
                      f"b4={row['b4_vs_plain']:.2e}", flush=True)
    return rows


def table7_ladder(*, quick: bool = False, device=None,
                  standin=None) -> dict:
    """Hook ΔPPL of the three kernel variants on the trained stand-in
    (``standin``, or smol-d128 trained here) with an alpha = 100 K
    outlier channel."""
    if standin is None:
        standin = trained_standin("smol-d128", device=device)
    cfg, model, params = standin.cfg, standin.model, standin.params
    # alpha=100: one K coordinate 100x the rest, the strong version of the
    # paper's Qwen layer-0 probe finding
    params = inject_kv_outliers(params, head_dim=cfg.head_dim, alpha=100.0,
                                inject_v=False)
    toks = eval_tokens(batch=4 if quick else 8, device=model.device)
    base = hook_ppl(model, params, toks, None, None)
    rots_plain = model.init_rotations(model.generator(1))
    rots_cal = calibrated_rots(model, params, toks, rots_plain)
    rows = []
    for variant, calibrated, kw in LADDER:
        ppl = hook_ppl(model, params, toks,
                       rots_cal if calibrated else rots_plain, kw)
        rows.append({"kernel_variant": variant, "ppl": ppl,
                     "dppl": ppl - base})
        print(f"  {variant:16s} dPPL={ppl - base:+.4f}", flush=True)
    d = {r["kernel_variant"]: r["dppl"] for r in rows}
    return {
        "model": cfg.name, "eval_tokens": list(toks.shape),
        "base_ppl": base, "rows": rows,
        "claims": {
            "scaled_g32_best": d["scaled_g32"] < d["g32_no_lambda"]
            and d["scaled_g32"] < d["per_token"],
            # the paper's 12.5x is checkpoint-specific; what must
            # reproduce is the fused recipe winning by a clear margin
            "reduction_over_per_token_large":
                d["per_token"] > 1.5 * max(d["scaled_g32"], 1e-3),
        },
    }


def kernel_claims(rows: list[dict]) -> dict:
    """The checks of the port's kernels (these gate; the ladder does not)."""
    return {
        "codes_match_up_to_ties": all(
            r["max_code_diff"] <= 1 and r["flips_off_tie"] == 0
            and 1.0 - r["int_agreement"] <= MAX_FLIP_SHARE for r in rows),
        "scales_match": all(r["scale_rel_err"] < SCALE_RTOL for r in rows),
        "b4_matches_plain": all(r["b4_vs_plain"] <= r["b4_tol"]
                                for r in rows),
    }


def run(*, quick: bool = False, device=None, name="smol-d128",
        steps: int = 250, n: Optional[int] = None, out_dir=None) -> dict:
    dev = resolve_device(device)
    exact = bit_exactness(n=n or (512 if quick else 2048), device=dev)
    standin = trained_standin(name, steps=steps, device=dev)
    ladder = table7_ladder(quick=quick, standin=standin)
    record = {
        "table": "table7_and_correctness",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "bit_exactness": exact,
        "standin": {"model": standin.cfg.name, "steps": steps,
                    "first_loss": standin.losses[0] if standin.losses
                    else None,
                    "final_loss": standin.losses[-1] if standin.losses
                    else None,
                    "seconds": standin.seconds},
        "quality_ladder": ladder,
        "claims": {
            **kernel_claims(exact),
            "int4_bit_exact": all(r["int_agreement"] == 1.0 for r in exact
                                  if r["bits"] == 4),
            **ladder["claims"],
        },
    }
    record["path"] = str(save_record("kernel_quality", record, out_dir))
    print(fmt_table(exact, ["d", "bits", "variant", "int_agreement",
                            "tie_flips", "scale_rel_err", "b4_vs_plain"]))
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda; raises without a card)")
    ap.add_argument("--quick", action="store_true",
                    help="512 rows per check and 4 x 256 eval tokens")
    args = ap.parse_args(argv)
    rec = run(quick=args.quick, device=args.device)
    print(json.dumps({"claims": rec["claims"], "standin": rec["standin"],
                      "base_ppl": rec["quality_ladder"]["base_ppl"],
                      "dppl": {r["kernel_variant"]: r["dppl"] for r in
                               rec["quality_ladder"]["rows"]}}))
    return 0 if all(kernel_claims(rec["bit_exactness"]).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
