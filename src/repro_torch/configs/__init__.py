"""Config registry (port of ``repro/configs/__init__.py``,
``paper_models.py`` and ``internlm2_1_8b.py``): the dense models the port
serves, plus ``reduced()`` for CPU-sized variants of the same family."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "reduced"]

# internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
# vocab=92544 [arXiv:2403.17297]
INTERNLM2_1_8B = ModelConfig(
    name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=92544,
    rope_theta=1e6,
).validated()

# the paper's head_dim regimes as small trainable stand-ins
SMOL_D64 = ModelConfig(
    name="smol-d64", family="dense", n_layers=4, d_model=256, n_heads=4,
    n_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=256,
    tie_embeddings=True,
).validated()

SMOL_D128 = ModelConfig(
    name="smol-d128", family="dense", n_layers=4, d_model=512, n_heads=4,
    n_kv_heads=2, head_dim=128, d_ff=1536, vocab_size=256,
    tie_embeddings=True,
).validated()

SMOL_D256 = ModelConfig(
    name="smol-d256", family="dense", n_layers=4, d_model=512, n_heads=4,
    n_kv_heads=1, head_dim=256, d_ff=1536, vocab_size=256,
    ffn_activation="geglu", rms_unit_offset=True, embed_scale=True,
    tie_embeddings=True,
).validated()

_CONFIGS = {c.name: c for c in (INTERNLM2_1_8B, SMOL_D64, SMOL_D128,
                                SMOL_D256)}
ARCH_IDS = list(_CONFIGS)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _CONFIGS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch: {arch_id}; known: {ARCH_IDS}") from None


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke variant of the same family: small layers/width (the
    dense branch of the reference's ``reduced``)."""
    out = dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32 if cfg.head_dim % 32 == 0 else 28,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=128,
    )
    return out.validated()
