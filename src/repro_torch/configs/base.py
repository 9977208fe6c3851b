"""Model configuration dataclasses (port of ``repro/configs/base.py:15-21``
and ``:41-104``).

The port's own copy: ``MoEConfig`` and the fields of the families the port
serves (dense, moe, vlm), with the same names and defaults as the
reference, and ``validated()``.  The recurrent families' fields (``ssm``,
``xlstm``, ``encoder_layers``, ``cross_attention``) come with their
modules (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MoEConfig", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    capacity_factor: float = 1.25
    group_size: int = 512  # tokens per dispatch group (GShard G axis)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm (hybrid, ssm, audio: ROADMAP A11)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # activation / FFN
    ffn_activation: str = "swiglu"  # swiglu | geglu | gelu (non-gated)
    # norm
    norm_eps: float = 1e-6
    rms_unit_offset: bool = False  # gemma-style (1 + w)
    embed_scale: bool = False  # gemma: embeddings * sqrt(d_model)
    tie_embeddings: bool = False
    # MoE
    moe: Optional[MoEConfig] = None
    # modality frontend stub: None | "vision" | "audio"
    frontend: Optional[str] = None
    n_patches: int = 1152  # vlm: patch-embedding count inside the sequence
    # KV-cache quantization (the paper's technique)
    kv_quant: bool = True
    kv_group: int = 32
    kv_window: int = 16  # fp32 residual window (paper §8)
    rotation: str = "srft"  # srft | srht | identity

    def validated(self) -> "ModelConfig":
        if self.head_dim % 2:
            raise ValueError("SRFT packing needs even head_dim")
        if self.head_dim % self.kv_group:
            # mixed-radix archs: largest even divisor of head_dim <= 32
            g = max(
                g
                for g in range(2, min(self.head_dim, 32) + 1)
                if self.head_dim % g == 0 and g % 2 == 0
            )
            return dataclasses.replace(self, kv_group=g)
        return self
