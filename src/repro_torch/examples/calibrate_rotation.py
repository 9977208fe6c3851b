"""Learned-rotation calibration walkthrough (port of
``examples/calibrate_rotation.py``; paper §5).

    python -m repro_torch.examples.calibrate_rotation [--device cpu]
        [--steps N]

Trains smol-d64 for ``--steps`` Adam steps (60 by default), patches in
the paper's outlier-channel mechanism (alpha = 20, §5.6), collects K/V
activations, then fits the paper's post-training variants on layer 0's K
vectors (120 Adam steps each, lr 1e-2, 4 bits, one group spanning d):

  static lambda  (train-free, one pass)            -- deployment default
  learned lambda (Adam on reconstruction MSE)      -- §5.1 (1)
  + Cayley R     (exact orthogonal, d^2 params)    -- §5.1 (2)
  + Householder  (k=d/2 reflectors, half params)   -- Table 3/4
  no-SRFT R      (the §5.3 ablation: best MSE, worse PPL downstream)

Prints the MSE-reduction ladder and each learned rotation's
orthogonality error.  Runs on ``cuda`` unless ``--device cpu`` is given;
without a card and without that flag it raises.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import calibrate as C
from repro_torch.core.outliers import inject_kv_outliers
from repro_torch.core.transforms import make_rotation
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.lm import LM

__all__ = ["main"]


def main(argv: Optional[list[str]] = None) -> dict:
    """Run the walkthrough; returns each row's MSE (and, for the learned
    rows, the reduction and the orthogonality error)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=60,
                    help="training steps before the activations are taken")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("smol-d64")
    model = LM(cfg, device=dev)
    params, opt = init_train_state(model, model.generator(0))
    it = DataIterator(SyntheticCorpus(0), batch_per_shard=8, seq_len=128,
                      device=dev)
    step = make_train_step(model, lr=3e-3)
    for _ in range(args.steps):
        params, opt, _ = step(params, opt, it.next())
    # inject the paper's outlier-channel mechanism so calibration has
    # real structure to learn (§5.6)
    params = inject_kv_outliers(params, head_dim=cfg.head_dim, alpha=20.0)

    d = cfg.head_dim
    with torch.no_grad():
        k_act, _ = model.collect_kv(params, it.next()["tokens"])
    acts = k_act[0].reshape(-1, d).float()  # layer 0 K activations
    print(f"collected {acts.shape[0]} K vectors (d={d}) from layer 0")

    base = make_rotation("srft", torch.Generator().manual_seed(1), d, dev)
    out: dict = {"device": str(dev), "n_vectors": acts.shape[0]}
    with torch.no_grad():
        mse0 = float(C.reconstruction_mse(base, acts, bits=4))
        rot_static = C.apply_static_lambda(base, C.static_lambda(base, acts))
        mse_static = float(C.reconstruction_mse(rot_static, acts, bits=4))
    print(f"random SRFT 4-bit reconstruction MSE: {mse0:.5f}")
    print(f"static per-channel lambda:  MSE {mse_static:.5f} "
          f"({100 * (1 - mse_static / mse0):.1f}% reduction, zero training)")
    out["random SRFT"] = {"mse": mse0}
    out["static lambda"] = {"mse": mse_static,
                            "mse_reduction": 1 - mse_static / mse0}

    eye = torch.eye(d, device=dev)
    variants = [
        ("learned lambda", "srft", dict(learn_lambda=True)),
        ("+ Cayley R", "srft", dict(learn_lambda=True, learn_cayley=True)),
        ("+ Householder k=d/2", "srft",
         dict(learn_lambda=True, learn_householder=d // 2)),
        ("no-SRFT (identity base)", "identity",
         dict(learn_lambda=True, learn_cayley=True)),
    ]
    for name, kind, kw in variants:
        b = base if kind == "srft" else make_rotation(
            "identity", torch.Generator().manual_seed(2), d, dev)
        rot, diag = C.calibrate(
            b, acts, bits=4, steps=120, lr=1e-2,
            generator=torch.Generator(device=dev).manual_seed(0), **kw)
        orth = float((rot.matrix @ rot.matrix.T - eye).abs().max())
        print(f"{name:26s} MSE {diag['mse_final']:.5f} "
              f"({100 * diag['mse_reduction']:.1f}% reduction)  "
              f"orthogonality err {orth:.1e}")
        out[name] = {"mse": diag["mse_final"],
                     "mse_reduction": diag["mse_reduction"],
                     "orthogonality_err": orth}

    print("""
note: the no-SRFT row typically reaches the LOWEST calibration MSE --
yet the paper (and the calibration ablation, which measures downstream
PPL) shows it gives WORSE perplexity than any SRFT-based variant:
calibration MSE is not a sufficient proxy for attention-level quality
(paper §5.3).""")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
