"""End-to-end training example (port of ``examples/train_lm.py``).

    python -m repro_torch.examples.train_lm [--device cpu] [--steps N]
        [--full] [--ckpt-dir DIR]

Trains TINY (tiny-33m, 4 layers x 384, byte vocab) or, with ``--full``,
the ~100M lm-100m (12 layers x 768) on the synthetic corpus, batch 8 x
256, cosine schedule with a 20-step warmup, under ``TrainSupervisor``:
checkpoints every max(steps // 3, 10) steps and on SIGTERM, keeps 2.
Run it again with the same ``--ckpt-dir`` and a larger ``--steps`` and it
resumes from the latest checkpoint (params, Adam state and the data
iterator's step): the loss curve continues instead of restarting.
Checkpoints go to ``artifacts/train_lm/`` at the root of the checkout
unless ``--ckpt-dir`` says otherwise.  Runs on ``cuda`` unless
``--device cpu`` is given; without a card and without that flag it
raises.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ModelConfig
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import LM
from repro_torch.optim.adam import adam_init, cosine_schedule, tree_leaves

__all__ = ["TINY", "FULL", "CKPT_DIR", "main"]

TINY = ModelConfig(
    name="tiny-33m", family="dense", n_layers=4, d_model=384, n_heads=6,
    n_kv_heads=3, head_dim=64, d_ff=1536, vocab_size=256,
    tie_embeddings=True,
).validated()

# ~100M: 12L x 768 with byte vocab
FULL = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=256,
    tie_embeddings=True,
).validated()

CKPT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "train_lm"


def main(argv: Optional[list[str]] = None) -> dict:
    """Train (or resume); returns the step it started from, the step it
    reached, the losses of its steps, the straggler steps and the
    checkpoint directory."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = FULL if args.full else TINY
    steps = args.steps or (300 if args.full else 60)
    model = LM(cfg, device=dev)
    params = model.init(model.generator(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[train_lm] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{steps} steps on {dev}")

    opt = adam_init(params)
    it = DataIterator(SyntheticCorpus(0), batch_per_shard=8, seq_len=256,
                      device=dev)
    train_step = make_train_step(model, lr=cosine_schedule(3e-3, 20, steps))

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    sup = TrainSupervisor(ckpt, it, ckpt_every=max(steps // 3, 10))
    losses = []

    def step_fn(state, batch):
        p, o, m = train_step(*state, batch)
        losses.append(float(m["loss"]))
        if int(o.step) % 20 == 0:
            print(f"  step {int(o.step):4d} loss {losses[-1]:.4f} "
                  f"lr {float(m['lr']):.2e}")
        return (p, o), m

    state, start = sup.maybe_resume((params, opt))
    if start:
        print(f"[resume] continuing from step {start} "
              "(previous run's checkpoint)")
    state, reached = sup.run(state, step_fn, start_step=start,
                             num_steps=steps)
    ckpt.save(reached, state, metadata={"data": it.state_dict()})
    if sup.straggler_steps:
        print(f"[stragglers] {len(sup.straggler_steps)} slow steps logged: "
              f"{sup.straggler_steps[:5]}")
    print(f"[done] reached step {reached}; checkpoints in {args.ckpt_dir}")
    return {"start": start, "reached": reached, "losses": losses,
            "stragglers": list(sup.straggler_steps),
            "ckpt_dir": args.ckpt_dir}


if __name__ == "__main__":
    main()
    sys.exit(0)
