"""Config registry (port of ``repro/configs/__init__.py``,
``paper_models.py`` and the per-arch modules): the ten architectures of
the reference (dense, moe, hybrid, ssm, vlm, audio) and the paper's
stand-ins, plus ``reduced()`` for CPU-sized variants of the same family, the
tooling's ``SHAPES`` and ``LONG_CONTEXT_ARCHS``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    XLSTMConfig,
)

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "XLSTMConfig",
           "ShapeConfig", "SHAPES", "ARCH_IDS", "LONG_CONTEXT_ARCHS",
           "get_config", "reduced"]

# internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
# vocab=92544 [arXiv:2403.17297]
INTERNLM2_1_8B = ModelConfig(
    name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=92544,
    rope_theta=1e6,
).validated()

# gemma-7b [dense]: 28L d_model=3072 16H (kv=16, MHA) d_ff=24576
# vocab=256000, GeGLU, head_dim=256 [arXiv:2403.08295]
GEMMA_7B = ModelConfig(
    name="gemma-7b", family="dense", n_layers=28, d_model=3072, n_heads=16,
    n_kv_heads=16, head_dim=256, d_ff=24576, vocab_size=256000,
    ffn_activation="geglu", rms_unit_offset=True, embed_scale=True,
    tie_embeddings=True, rope_theta=10000.0,
).validated()

# qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
# vocab=151936, qk_norm [hf:Qwen/Qwen3-8B family]
QWEN3_14B = ModelConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=17408, vocab_size=151936, qk_norm=True,
    rope_theta=1e6,
).validated()

# qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
# vocab=152064, QKV bias [hf:Qwen/Qwen1.5 family]
QWEN1_5_110B = ModelConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=49152, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
).validated()

# dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert)
# vocab=100352, 16 experts top-4 [hf:databricks/dbrx-base]
DBRX_132B = ModelConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, head_dim=128, d_ff=10752, vocab_size=100352,
    rope_theta=5e5, moe=MoEConfig(n_experts=16, top_k=4, d_expert=10752),
).validated()

# llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
# vocab=64000 [hf:llava-hf/llava-v1.6 family]; the vision frontend is a
# stub: callers pass patch embeddings (B, n_patches, d_model)
LLAVA_NEXT_34B = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab_size=64000,
    rope_theta=5e6, frontend="vision", n_patches=1152,
).validated()

# qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
# (per expert) vocab=151936, 128 experts top-8, qk_norm
# [hf:Qwen/Qwen3-30B-A3B family]
QWEN3_MOE_235B_A22B = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, head_dim=128, d_ff=1536, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
).validated()

# zamba2-7b [hybrid]: 81 Mamba2 blocks d_model=3584 + one shared attention
# block (32H, kv=32, d_ff=14336) applied after every 6 of them, vocab=32000,
# ssm_state=64 [arXiv:2411.15242].  head_dim = 3584/32 = 112, the paper's
# mixed-radix SRFT case: validated() sets kv_group to 28, the largest even
# divisor of 112 that is at most 32.
ZAMBA2_7B = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, chunk=256),
    shared_attn_period=6, rope_theta=10000.0,
).validated()

# xlstm-1.3b [ssm]: 48 blocks d_model=2048 4H vocab=50304, an sLSTM block
# after every 7 mLSTM blocks [arXiv:2405.04517]; no attention KV cache
XLSTM_1_3B = ModelConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048, n_heads=4,
    n_kv_heads=4, head_dim=512, d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(slstm_period=8, expand=2, qk_dim_factor=0.5),
    kv_quant=False,
).validated()

# whisper-large-v3 [audio]: encoder-decoder, 32 + 32 layers d_model=1280
# 20H (MHA) d_ff=5120 vocab=51866 [arXiv:2212.04356]; the conv frontend is
# a stub (callers pass frame embeddings (B, S_enc, d_model)); the decoder's
# self-attention cache and its read-only cross-attention cache are both
# served by the policy; absolute positions, no RoPE
WHISPER_LARGE_V3 = ModelConfig(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, head_dim=64, d_ff=5120, vocab_size=51866,
    ffn_activation="gelu", encoder_layers=32, cross_attention=True,
    frontend="audio", rope_theta=0.0,
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

_CONFIGS = {c.name: c for c in (
    ZAMBA2_7B, QWEN3_MOE_235B_A22B, DBRX_132B, QWEN3_14B, QWEN1_5_110B,
    GEMMA_7B, INTERNLM2_1_8B, LLAVA_NEXT_34B, WHISPER_LARGE_V3, XLSTM_1_3B,
    SMOL_D64, SMOL_D128, SMOL_D256)}
ARCH_IDS = list(_CONFIGS)

# archs with sub-quadratic backbones: the only ones running long_500k
LONG_CONTEXT_ARCHS = ("zamba2-7b", "xlstm-1.3b")


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _CONFIGS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch: {arch_id}; known: {ARCH_IDS}") from None


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke variant of the same family: small layers/width/experts
    (the reference's ``reduced``)."""
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32 if cfg.head_dim % 32 == 0 else 28,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=128,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=4, top_k=2, d_expert=64, group_size=32,
            capacity_factor=cfg.moe.capacity_factor)
        kw["d_ff"] = 64
    if cfg.xlstm is not None:
        kw["n_layers"] = cfg.xlstm.slstm_period  # one sLSTM + mLSTMs
        kw["head_dim"] = 32
    if cfg.shared_attn_period:
        kw["n_layers"] = cfg.shared_attn_period + 1  # one shared firing
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    return dataclasses.replace(cfg, **kw).validated()
