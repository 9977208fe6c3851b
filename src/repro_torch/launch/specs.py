"""Stand-ins for every model input of an (arch x shape) cell, with no
storage (port of ``repro/launch/specs.py``).

The reference returns ``jax.ShapeDtypeStruct``s; the port returns
tensors on the ``meta`` device, which carry a shape and a dtype and
allocate nothing, so the port's own constructors (``init_cache``) build
them:

  ``input_specs(cfg, shape)``
    train / prefill: ``{"tokens": (B, S)}``, an audio cell also
    ``"frames"`` (B, S, d_model) beside ``"tokens"``, a vlm cell
    ``"patches"`` (B, P, d_model) with the tokens shortened so that the
    positions total S; decode: ``{"token": (B, 1)}``.
  ``serve_cache_shapes(model, cfg, shape)``
    the serving cache of a model built on ``meta`` (``build_model(cfg,
    device="meta")``): ``REPRO_KV_CACHE`` names a registered policy
    ("bf16", "int8-per-token", ...; empty or "int4" keeps the config's
    default), and an audio decode cell's encoder holds
    ``WHISPER_DECODE_ENC_LEN`` frames.

The modality front ends are stubs, as in the reference: frames and
patches are precomputed embeddings.
"""
from __future__ import annotations

import os

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import COMPUTE_DTYPE

__all__ = ["input_specs", "serve_cache_shapes", "WHISPER_DECODE_ENC_LEN"]

WHISPER_DECODE_ENC_LEN = 1504  # 1500 rounded up to the residual window


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": _meta((B, 1), torch.int32)}
    out = {}
    if cfg.family == "audio":
        # encoder frames + decoder transcript, both seq_len
        out["frames"] = _meta((B, S, cfg.d_model), COMPUTE_DTYPE)
        out["tokens"] = _meta((B, S), torch.int32)
    elif cfg.family == "vlm":
        n_p = min(cfg.n_patches, S // 2)
        out["patches"] = _meta((B, n_p, cfg.d_model), COMPUTE_DTYPE)
        out["tokens"] = _meta((B, S - n_p), torch.int32)
    else:
        out["tokens"] = _meta((B, S), torch.int32)
    return out


def serve_cache_shapes(model, cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The serving cache of the cell, from ``model.init_cache`` on a model
    built on ``meta`` (nothing is allocated)."""
    if model.device.type != "meta":
        raise ValueError(f"serve_cache_shapes takes a model built on the "
                         f"meta device (got {model.device}): "
                         f"build_model(cfg, device='meta')")
    env = os.environ.get("REPRO_KV_CACHE", "")
    policy = None if env in ("", "int4") else env
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        enc_len = S if shape.kind == "prefill" else WHISPER_DECODE_ENC_LEN
        return model.init_cache(B, S, enc_len, policy=policy)
    return model.init_cache(B, S, policy=policy)
