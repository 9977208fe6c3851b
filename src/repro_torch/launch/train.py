"""Training CLI (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch internlm2-1.8b --steps 200 \
        --ckpt-dir DIR [--mesh 2x2] [--resume] [--smoke] [--layers N] \
        [--device cpu]

Wires the substrates together: config registry -> model -> synthetic data
iterator -> train step (autograd through the plain modules, clip, AdamW)
-> atomic checkpoints with the iterator's state, and exact resume from
the latest one through ``TrainSupervisor``.  ``--smoke`` shrinks the arch
to a CPU-trainable depth and width with the same wiring; ``--layers N``
cuts the depth alone (the reference's CLI has no such flag).  Runs on
``cuda`` unless ``--device cpu`` is given; without a card and without
that flag it raises before building anything.

``--mesh AxB`` is a mesh over ('data', 'model'), ``AxBxC`` over ('pod',
'data', 'model') (``A`` alone: ('data',)), of the first A·B(·C) visible
cards, or of the CPU with ``--device cpu`` (one device: only a mesh of
one).  Asking for more devices than are visible exits before anything is
built.  Under a mesh the params and the Adam state are placed by
``partitioning.param_specs`` (``REPRO_SHARDING=sp_fsdp`` selects the FSDP
layout, as the reference's rules read it; otherwise ``baseline``) and the
step is ``sharded_train.make_sharded_train_step``: data parallel over
('pod', 'data'), the storage split over every axis a spec uses.
``--resume`` re-places the restored state by the new mesh's specs, so a
run checkpointed on one mesh resumes on another.  A simulated mesh (a
repeated device) is built from Python: ``make_mesh((4, 2), ("data",
"model"), devices=["cpu"] * 8)`` and ``make_sharded_train_step``.

The reference's docstring names ``--compress-grads``, which its parser
does not have, and nothing of the reference calls ``compressed_psum``; the
port has neither (``distributed/compression.py`` is ported on its own).
The data pipeline yields tokens only, so an audio arch (whose loss needs
``frames``) raises a ``ValueError`` that says so; the reference's CLI
fails on the missing key inside its loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager, leaves
from repro_torch.configs import ModelConfig, get_config
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.launch.mesh import make_mesh, visible_cards
from repro_torch.launch.sharded_train import (
    make_sharded_train_step,
    shard_train_state,
    train_state_specs,
)
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import LM
from repro_torch.optim.adam import adam_init, cosine_schedule, tree_leaves

__all__ = ["smoke_config", "parse_mesh", "main"]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """CPU-trainable reduction preserving the family structure (ref
    ``train.py:37-55``): a MoE keeps its expert width and group size, with
    4 experts, top 2; a hybrid fires its shared block every 2 of 4 Mamba2
    blocks; an ssm keeps one group of its sLSTM period; an audio model
    keeps at most 2 encoder and 2 decoder layers."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4), d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4), n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=min(cfg.head_dim, 64),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512))
    if cfg.family == "hybrid":
        kw["shared_attn_period"] = 2
        kw["n_layers"] = 4
    if cfg.family == "ssm":
        kw["n_layers"] = cfg.xlstm.slstm_period
    if cfg.family == "audio":
        kw["encoder_layers"] = min(cfg.encoder_layers, 2)
        kw["n_layers"] = min(cfg.n_layers, 2)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4, top_k=2)
    return dataclasses.replace(cfg, **kw).validated()


def parse_mesh(arg: Optional[str], dev: torch.device):
    """``--mesh`` -> a mesh of the first devices (the visible cards, or
    ``dev`` itself off CUDA), or None without the flag; more devices than
    are visible end in a ``SystemExit`` that names them."""
    if not arg:
        return None
    dims = tuple(int(x) for x in arg.split("x"))
    names = ("data", "model")[:len(dims)] if len(dims) <= 2 else (
        "pod", "data", "model")
    devs = visible_cards() if dev.type == "cuda" else [dev]
    n = int(np.prod(dims))
    if n > len(devs):
        raise SystemExit(
            f"error: --mesh {arg} asks for {n} devices and {len(devs)} "
            f"{'are' if len(devs) != 1 else 'is'} visible "
            f"({', '.join(map(str, devs)) or 'none'}); a simulated mesh "
            f"repeats one device: build it from Python with "
            f"repro_torch.launch.mesh.make_mesh({dims}, {names}, "
            f"devices=['{dev}'] * {n}) and "
            f"repro_torch.launch.sharded_train.make_sharded_train_step")
    return make_mesh(dims, names, devs[:n])


def main(argv: Optional[list[str]] = None, *,
         on_step: Optional[Callable[[int, dict], None]] = None):
    """Train as the flags say; returns the final (params, opt_state),
    ``Sharded`` leaves under ``--mesh`` (``partitioning.gather_tree``
    assembles them).

    ``on_step(step, metrics)``, if given, is called after every step (an
    in-process caller's hook, e.g. for timing with CUDA events)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--mesh", default=None,
                    help="AxB over (data, model) or AxBxC over (pod, data, "
                         "model), e.g. 1x1, 2x2, 2x2x2")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduce the arch to CPU-trainable size")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch's depth to this many layers, its "
                         "width kept (after --smoke)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = parse_mesh(args.mesh, dev)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers).validated()
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the training CLI feeds tokens only (the synthetic "
            f"data pipeline has no frames), and an audio model's loss needs "
            f"batch['frames']; train it through EncDec.loss with frame "
            f"embeddings")
    model = LM(cfg, device=dev)
    params = model.init(model.generator(args.seed))
    n_params = sum(t.numel() for t in tree_leaves(params))
    lr = cosine_schedule(args.lr, args.warmup, args.steps)
    sharding_fn = None
    if mesh is None:
        state = (params, adam_init(params))
        step_fn = make_train_step(model, lr=lr)
    else:
        layout = ("sp_fsdp" if os.environ.get("REPRO_SHARDING") == "sp_fsdp"
                  else "baseline")
        specs = leaves(train_state_specs(params, mesh, layout=layout))
        state = shard_train_state(params, adam_init(params), mesh,
                                  layout=layout)
        step_fn = make_sharded_train_step(model, mesh, lr=lr, layout=layout)

        def sharding_fn(i, example):
            return mesh, specs[i]
    # the loop rebinds ``state``; no other name may keep the first tree
    # alive (the reference donates it to its jitted step)
    del params
    it = DataIterator(SyntheticCorpus(args.seed), shard_id=0, num_shards=1,
                      batch_per_shard=args.batch, seq_len=args.seq,
                      device=dev)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    start = 0
    if ckpt is not None:
        sup = TrainSupervisor(ckpt, it, ckpt_every=args.ckpt_every)
        if args.resume:
            state, start = sup.maybe_resume(state, sharding_fn=sharding_fn)
            if start:
                print(f"[resume] from step {start}")

    print(f"[train] arch={cfg.name} family={cfg.family} "
          f"layers={cfg.n_layers} d={cfg.d_model} "
          f"params={n_params / 1e6:.1f}M "
          f"mesh={dict(mesh.shape) if mesh else None} device={dev}")

    step = start
    t_last = time.time()
    losses = []
    while step < args.steps:
        p, o, m = step_fn(*state, it.next())
        state = (p, o)
        step += 1
        losses.append(float(m["loss"]))
        if on_step is not None:
            on_step(step, m)
        if step % args.log_every == 0:
            dt = (time.time() - t_last) / args.log_every
            t_last = time.time()
            print(f"  step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"{dt * 1e3:.0f} ms/step")
        if ckpt is not None and step % args.ckpt_every == 0:
            ckpt.save(step, state, metadata={"data": it.state_dict()})
    if ckpt is not None:
        ckpt.save(args.steps, state, metadata={"data": it.state_dict()})
    print(f"[done] loss {losses[0] if losses else float('nan'):.4f} -> "
          f"{losses[-1] if losses else float('nan'):.4f}")
    return state


if __name__ == "__main__":
    main()
