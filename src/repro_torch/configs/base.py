"""Model configuration dataclasses (port of ``repro/configs/base.py:15-120``).

The port's own copy: ``MoEConfig``, ``SSMConfig``, ``XLSTMConfig`` and the
fields of every family the port serves (dense, moe, vlm, hybrid, ssm,
audio), with the same names and defaults as the reference,
``kv_applicable`` and ``validated()``; ``ShapeConfig`` and ``SHAPES``, the
reference's four (batch, sequence) cells of the analytic tooling
(``launch/specs.py``, ``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MoEConfig", "SSMConfig", "XLSTMConfig", "ModelConfig",
           "ShapeConfig", "SHAPES", "ATTENTION_FAMILIES"]

# the families without recurrent state: the only ones with per-row cache
# lengths (continuous batching, paged caches, chunked prefill, spec)
ATTENTION_FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    capacity_factor: float = 1.25
    group_size: int = 512  # tokens per dispatch group (GShard G axis)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    n_groups: int = 1
    chunk: int = 256  # SSD chunk length of the parallel (prefill) form


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_period: int = 8  # every Nth block is sLSTM, the rest mLSTM
    expand: int = 2
    qk_dim_factor: float = 0.5
    chunk: int = 64  # chunkwise-parallel mLSTM / chunked sLSTM length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
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
    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    shared_attn_period: int = 0  # zamba2: shared attn block every P blocks
    # xLSTM
    xlstm: Optional[XLSTMConfig] = None
    # enc-dec (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub: None | "vision" | "audio"
    frontend: Optional[str] = None
    n_patches: int = 1152  # vlm: patch-embedding count inside the sequence
    # KV-cache quantization (the paper's technique)
    kv_quant: bool = True
    kv_group: int = 32
    kv_window: int = 16  # fp32 residual window (paper §8)
    rotation: str = "srft"  # srft | srht | identity

    @property
    def kv_applicable(self) -> bool:
        """Does the arch keep an attention KV cache?  (xlstm does not.)"""
        return self.family != "ssm"

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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
