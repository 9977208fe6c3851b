"""Dense FFN variants: SwiGLU, GeGLU, plain GELU (port of
``repro/models/ffn.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common

__all__ = ["ffn_init", "ffn_apply"]


def ffn_init(generator: torch.Generator, d_model: int, d_ff: int,
             activation: str, device="cpu"):
    def mk(d_in, d_out):
        return common.dense_init(generator, d_in, d_out, device=device)

    if activation in ("swiglu", "geglu"):
        return {"w_gate": mk(d_model, d_ff), "w_up": mk(d_model, d_ff),
                "w_down": mk(d_ff, d_model)}
    if activation == "gelu":
        return {"w_up": mk(d_model, d_ff), "w_down": mk(d_ff, d_model)}
    raise ValueError(f"unknown activation {activation}")


def ffn_apply(p, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation in ("swiglu", "geglu"):
        h = common.dense(p["w_gate"], x).float()
        g = F.silu(h) if activation == "swiglu" else F.gelu(
            h, approximate="tanh")
        u = common.dense(p["w_up"], x).float()
        return common.dense(p["w_down"], (g * u).to(common.COMPUTE_DTYPE))
    if activation == "gelu":
        h = F.gelu(common.dense(p["w_up"], x).float(), approximate="tanh")
        return common.dense(p["w_down"], h.to(common.COMPUTE_DTYPE))
    raise ValueError(f"unknown activation {activation}")
