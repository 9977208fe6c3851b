"""Shared quality-benchmark infrastructure (port of ``benchmarks/common.py``
and ``benchmarks/ppl_scaling_schemes.py:24``).

Stand-in models: the paper evaluates pretrained SmolLM2 / Qwen / Gemma
checkpoints; none ship offline, so the benchmarks train the ``smol-*``
stand-ins (the same head_dim regimes) on the synthetic corpus.  The port
trains in memory on every call (the reference caches the trained params
on disk with its checkpoint manager; the port's ``CheckpointManager``
could, but a run here depends on nothing another run left).  Absolute
PPLs differ from the paper; the orderings and mechanisms are what is
measured.
Records go to ``artifacts/bench_torch/`` at the root of the checkout.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.calibrate import apply_static_lambda, static_lambda
from repro_torch.core.transforms import Rotation
from repro_torch.data import DataIterator, SyntheticCorpus
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.lm import LM

__all__ = ["BENCH_DIR", "Standin", "save_record", "trained_standin",
           "eval_tokens", "hook_ppl", "calibrated_rots", "fmt_table"]

BENCH_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "bench_torch"


class Standin(NamedTuple):
    cfg: ModelConfig
    model: LM
    params: dict
    losses: list  # training loss of every step
    seconds: float  # training wall time (host clock, ends in a readback)


def save_record(name: str, record: dict, out_dir: Optional[Path] = None
                ) -> Path:
    out_dir = Path(out_dir) if out_dir is not None else BENCH_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.json"
    path.write_text(json.dumps(record, indent=2, default=float))
    return path


def trained_standin(name: Union[str, ModelConfig] = "smol-d64", *,
                    steps: int = 250, lr: float = 3e-3, seed: int = 0,
                    device=None) -> Standin:
    """A stand-in (a config name, or a config) trained for ``steps`` Adam
    steps of 8 x 128 corpus tokens from ``seed``."""
    cfg = get_config(name) if isinstance(name, str) else name
    model = LM(cfg, device=device)
    params, opt = init_train_state(model, model.generator(seed))
    it = DataIterator(SyntheticCorpus(seed), batch_per_shard=8, seq_len=128,
                      device=model.device)
    step = make_train_step(model, lr=lr)
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        params, opt, m = step(params, opt, it.next())
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist() if losses else []
    seconds = time.perf_counter() - t0
    if losses:
        print(f"[standin {cfg.name}] trained {steps} steps on "
              f"{model.device}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({seconds:.1f}s)", flush=True)
    return Standin(cfg, model, params, losses, seconds)


def eval_tokens(seed: int = 100, *, batch: int = 8, seq_len: int = 256,
                device=None) -> torch.Tensor:
    """Held-out eval tokens (B, S) torch.long (never in a training shard)."""
    it = DataIterator(SyntheticCorpus(seed), batch_per_shard=batch,
                      seq_len=seq_len, device=device)
    return it.next()["tokens"]


@torch.no_grad()
def hook_ppl(model: LM, params, tokens: torch.Tensor, rots,
             kv_quant_cfg: Optional[dict]) -> float:
    """Teacher-forced PPL with the paper's KV round-trip hook (§3.3);
    ``kv_quant_cfg=None`` is the full-precision PPL."""
    logits = model.forward(params, tokens, rots=rots,
                           kv_quant_cfg=kv_quant_cfg, remat=False)
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -lp.gather(-1, tokens[:, 1:, None])[..., 0]
    return float(torch.exp(nll.mean()))


@torch.no_grad()
def calibrated_rots(model: LM, params, tokens: torch.Tensor,
                    rots: list[tuple[Rotation, Rotation]]
                    ) -> list[tuple[Rotation, Rotation]]:
    """Static per-channel lambda from one forward pass (paper §7.1), per
    layer and per side."""
    k_act, v_act = model.collect_kv(params, tokens)
    return [(apply_static_lambda(rk, static_lambda(rk, k_act[i])),
             apply_static_lambda(rv, static_lambda(rv, v_act[i])))
            for i, (rk, rv) in enumerate(rots)]


def fmt_table(rows: list[dict], cols: list[str]) -> str:
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    out = ["  ".join(c.ljust(widths[c]) for c in cols),
           "  ".join("-" * widths[c] for c in cols)]
    for r in rows:
        out.append("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))
    return "\n".join(out)
