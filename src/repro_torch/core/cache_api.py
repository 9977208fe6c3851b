"""KV-cache policies behind one protocol (port of
``repro/core/cache_api.py``: ``AttendBackend``, ``CacheState``, the
registry, ``policy_from_config``, ``BF16Policy`` and ``Int4SRFTPolicy``;
dense non-ragged lifecycle only).

    pol   = get_policy("int4-srft", group=32, window=16)
    state = pol.init_state(B, Hkv, S_max, d, generator=g, device=dev)
    state = pol.prefill(state, k, v)          # bulk insert (in place)
    state = pol.update(state, k, v)           # decode append (in place)
    out   = pol.attend(q, state, backend=AttendBackend.KERNEL)

The model code never branches on the scheme: a ``CacheState`` carries its
policy.  ``attend`` raises for a backend a policy does not implement; it
never switches paths silently.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import torch

from repro_torch.core import kvcache
from repro_torch.core.kvcache import QuantKVCache
from repro_torch.core.quant_attention_ref import (
    decode_attention_bf16,
    decode_attention_quant,
)
from repro_torch.core.transforms import Rotation, make_rotation

__all__ = [
    "AttendBackend",
    "CacheState",
    "BF16Policy",
    "Int4SRFTPolicy",
    "Int4State",
    "register_policy",
    "get_policy",
    "policy_from_config",
]


class AttendBackend(enum.Enum):
    """Decode read path."""

    GATHER = "gather"  # one-shot dequant, plain PyTorch
    KERNEL = "kernel"  # kernel B1 (plain version on CPU tensors)

    @classmethod
    def parse(cls, value: "AttendBackend | str | None") -> "AttendBackend":
        if value is None:
            return cls.GATHER
        if isinstance(value, AttendBackend):
            return value
        try:
            return cls(str(value).lower())
        except ValueError:
            names = ", ".join(b.value for b in cls)
            raise ValueError(
                f"unknown attend backend {value!r} (have: {names})"
            ) from None


@dataclasses.dataclass
class CacheState:
    """A per-layer cache state that knows its own policy."""

    policy: Any
    data: Any

    @property
    def length(self) -> int:
        return self.data.length

    def nbytes(self) -> int:
        return self.policy.nbytes(self)


_REGISTRY: dict[str, type] = {}


def register_policy(name: str):
    """Class decorator: ``@register_policy("int4-srft")``."""

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        _REGISTRY[name] = cls
        cls.name = name
        return cls

    return deco


def get_policy(name: str, **hyperparams):
    """Instantiate a registered policy; hyperparameters the scheme does not
    take (e.g. ``window`` for bf16) are dropped."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown cache policy {name!r} "
            f"(registered: {', '.join(sorted(_REGISTRY))})"
        ) from None
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in hyperparams.items() if k in fields})


def policy_from_config(cfg, policy=None):
    """An instance (returned as-is), a registry name, or None (the config
    picks "int4-srft" when ``kv_quant``, else "bf16")."""
    if policy is None:
        policy = "int4-srft" if getattr(cfg, "kv_quant", False) else "bf16"
    if isinstance(policy, str):
        return get_policy(
            policy,
            group=getattr(cfg, "kv_group", 32),
            window=getattr(cfg, "kv_window", 16),
            rotation=getattr(cfg, "rotation", "srft"),
        )
    return policy


def _leaf_bytes(*leaves: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


def _unsupported(policy, backend: AttendBackend):
    names = ", ".join(b.value for b in policy.supported_backends)
    raise NotImplementedError(
        f"{policy.name} implements the {names} read paths in this port "
        f"(got {backend.value})"
    )


@register_policy("bf16")
@dataclasses.dataclass(frozen=True)
class BF16Policy:
    """Uncompressed bf16 cache (the paper's fp16 DynamicCache analogue)."""

    supported_backends = (AttendBackend.GATHER,)

    def init_state(self, batch, n_kv_heads, s_max, head_dim, *,
                   generator: Optional[torch.Generator] = None,
                   device="cpu"):
        return CacheState(self, kvcache.init_bf16_cache(
            batch, n_kv_heads, s_max, head_dim, device=device))

    def with_rotations(self, state, rot_k, rot_v):
        return state  # no rotation state

    def prefill(self, state, k, v):
        kvcache.bf16_prefill(state.data, k, v)
        return state

    def update(self, state, k, v):
        kvcache.bf16_decode_update(state.data, k, v)
        return state

    def attend(self, q, state, *, scale=None, backend=None, kv_block=512,
               sliding_window=None):
        backend = AttendBackend.parse(backend)
        if backend is not AttendBackend.GATHER:
            _unsupported(self, backend)
        return decode_attention_bf16(q, state.data, scale=scale,
                                     sliding_window=sliding_window)

    def nbytes(self, state):
        return _leaf_bytes(state.data.k, state.data.v)

    def compression_ratio(self, state) -> float:
        return 1.0


@dataclasses.dataclass
class Int4State:
    """int4 policy state: packed KV + the per-layer rotations that made it."""

    kv: QuantKVCache
    rot_k: Rotation
    rot_v: Rotation

    @property
    def length(self) -> int:
        return self.kv.length


@register_policy("int4-srft")
@dataclasses.dataclass(frozen=True)
class Int4SRFTPolicy:
    """SRFT rotation + per-channel lambda + int4 per-group codes + fp32
    residual window (paper §7.1-7.2).  Writes go through kernel B3; the
    KERNEL read through kernel B1."""

    supported_backends = (AttendBackend.GATHER, AttendBackend.KERNEL)

    group: int = 32
    window: int = 16
    rotation: str = "srft"  # srft | srht | identity

    def init_state(self, batch, n_kv_heads, s_max, head_dim, *,
                   generator: Optional[torch.Generator] = None,
                   device="cpu"):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return CacheState(self, Int4State(
            kv=kvcache.init_cache(batch, n_kv_heads, s_max, head_dim,
                                  group=self.group, window=self.window,
                                  device=device),
            rot_k=make_rotation(self.rotation, generator, head_dim, device),
            rot_v=make_rotation(self.rotation, generator, head_dim, device),
        ))

    def with_rotations(self, state, rot_k, rot_v):
        return CacheState(self, dataclasses.replace(state.data, rot_k=rot_k,
                                                    rot_v=rot_v))

    def prefill(self, state, k, v):
        d = state.data
        kvcache.prefill(d.kv, d.rot_k, d.rot_v, k, v)
        return state

    def update(self, state, k, v):
        d = state.data
        kvcache.decode_update(d.kv, d.rot_k, d.rot_v, k, v)
        return state

    def attend(self, q, state, *, scale=None, backend=None, kv_block=512,
               sliding_window=None):
        backend = AttendBackend.parse(backend)
        d = state.data
        if backend is AttendBackend.KERNEL:
            if sliding_window is not None:
                raise NotImplementedError(
                    "int4-srft: the B1 kernel does not implement "
                    "sliding_window; use AttendBackend.GATHER"
                )
            from repro_torch.kernels.quant_attention import (
                decode_attention_kernel,
            )

            return decode_attention_kernel(q, d.kv, d.rot_k, d.rot_v,
                                           scale=scale, blk=kv_block)
        if backend is not AttendBackend.GATHER:
            _unsupported(self, backend)
        return decode_attention_quant(q, d.kv, d.rot_k, d.rot_v, scale=scale,
                                      sliding_window=sliding_window)

    def nbytes(self, state):
        """Persistent bytes: packed codes + scales.  The O(W) fp32 residual
        window and the rotations (model constants) are not counted."""
        kv = state.data.kv
        return _leaf_bytes(kv.k_packed, kv.k_scales, kv.v_packed, kv.v_scales)

    def compression_ratio(self, state) -> float:
        """bf16-equivalent bytes / persistent bytes (paper §4.5)."""
        kv = state.data.kv
        d = kv.k_packed.shape[-1] * 2
        n_vectors = kv.k_packed.numel() // (d // 2)
        return 2 * 2 * n_vectors * d / self.nbytes(state)
