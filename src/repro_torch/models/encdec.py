"""Whisper-style encoder-decoder, the audio family (port of
``repro/models/encdec.py``).

The conv frontend is a stub: ``encode`` takes precomputed frame
embeddings (B, S_enc, d_model).  A decoder layer is a causal
self-attention (its cache written at every step), a cross-attention into
the encoder states (K/V projected once at prefill and stored through the
cache policy: a read-only cache of ``s_cross = ((S_enc + W - 1) // W + 1)
* W`` slots that every decode step reads) and a GELU FFN.  LayerNorm,
sinusoidal encoder positions, a learned table of 65,536 decoder
positions, no RoPE.

As in ``models/lm.py``, the reference's scans become loops over lists of
per-layer dicts and cache states, updated in place.  ``pos`` is a Python
int or, with ``init_cache(..., ragged=True)``, a (B,) int32 device tensor
(every row at one length) that a captured decode step advances in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache_api
from repro_torch.core.hooks import make_roundtrip
from repro_torch.core.transforms import Rotation, make_rotation
from repro_torch.models import attention, common, ffn

__all__ = ["EncDec", "EncDecRotations", "MAX_DECODER_POSITIONS"]

MAX_DECODER_POSITIONS = 1 << 16  # learned decoder positions table size

RotPairs = list[tuple[Rotation, Rotation]]


class EncDecRotations(NamedTuple):
    self_kv: RotPairs  # decoder self-attention caches, one pair a layer
    cross_kv: RotPairs  # cross-attention caches, one pair a layer


class EncDec:
    """Functional encoder-decoder; ``device`` defaults to ``cuda`` and
    raises without a card, CPU runs pass ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        if cfg.family != "audio":
            raise ValueError(f"EncDec serves the audio family (got "
                             f"{cfg.family})")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _enc_layer_init(self, g):
        cfg, dev = self.cfg, self.device
        return {
            "ln_attn": common.layernorm_init(cfg.d_model, dev),
            "attn": attention.attention_init(g, cfg, dev),
            "ln_ffn": common.layernorm_init(cfg.d_model, dev),
            "ffn": ffn.ffn_init(g, cfg.d_model, cfg.d_ff, "gelu", dev),
        }

    def _dec_layer_init(self, g):
        cfg, dev = self.cfg, self.device
        return {
            "ln_self": common.layernorm_init(cfg.d_model, dev),
            "self_attn": attention.attention_init(g, cfg, dev),
            "ln_cross": common.layernorm_init(cfg.d_model, dev),
            "cross_attn": attention.attention_init(g, cfg, dev),
            "ln_ffn": common.layernorm_init(cfg.d_model, dev),
            "ffn": ffn.ffn_init(g, cfg.d_model, cfg.d_ff, "gelu", dev),
        }

    def init(self, generator: torch.Generator) -> dict:
        cfg, dev, g = self.cfg, self.device, generator
        pos = torch.randn((MAX_DECODER_POSITIONS, cfg.d_model), generator=g,
                          dtype=torch.float32, device=dev) * 0.01
        return {
            "embed": common.embed_init(g, cfg.vocab_size, cfg.d_model, dev),
            "dec_pos": pos.to(common.PARAM_DTYPE),
            "enc_layers": [self._enc_layer_init(g)
                           for _ in range(cfg.encoder_layers)],
            "dec_layers": [self._dec_layer_init(g)
                           for _ in range(cfg.n_layers)],
            "ln_enc_final": common.layernorm_init(cfg.d_model, dev),
            "ln_dec_final": common.layernorm_init(cfg.d_model, dev),
            "unembed": common.dense_init(g, cfg.d_model, cfg.vocab_size,
                                         device=dev),
        }

    def init_rotations(self, generator: torch.Generator) -> EncDecRotations:
        cfg = self.cfg

        def pairs():
            return [tuple(make_rotation(cfg.rotation, generator,
                                        cfg.head_dim, self.device)
                          for _ in "kv") for _ in range(cfg.n_layers)]

        return EncDecRotations(self_kv=pairs(), cross_kv=pairs())

    # ----------------------------------------------------------------- cache
    def cache_policy(self, policy=None):
        return cache_api.policy_from_config(self.cfg, policy)

    def init_cache(self, batch: int, s_max_dec: int, s_enc: int, *,
                   policy=None, rots: Optional[EncDecRotations] = None,
                   generator: Optional[torch.Generator] = None,
                   ragged: bool = False) -> dict:
        """``{"self": [CacheState] * L, "cross": [CacheState] * L, "pos"}``.
        The cross caches hold ``s_cross = ((s_enc + W - 1) // W + 1) * W``
        slots (1520 for 1500 frames at W = 16): they are filled once at
        prefill and only read after.  ``ragged=True`` keeps the lengths
        and ``pos`` on the device (every row at one length)."""
        cfg, dev = self.cfg, self.device
        pol = self.cache_policy(policy)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        window = getattr(pol, "window", 1)
        s_cross = ((s_enc + window - 1) // window + 1) * window

        def mk(s, side):
            out = []
            for i in range(cfg.n_layers):
                st = pol.init_state(batch, cfg.n_kv_heads, s, cfg.head_dim,
                                    generator=generator, device=dev,
                                    ragged=ragged)
                if rots is not None:
                    st = pol.with_rotations(st, *getattr(rots, side)[i])
                out.append(st)
            return out

        return {
            "self": mk(s_max_dec, "self_kv"),
            "cross": mk(s_cross, "cross_kv"),
            "pos": (torch.zeros((batch,), dtype=torch.int32, device=dev)
                    if ragged else 0),
        }

    def step_state(self, cache: dict) -> list:
        """The tensors a decode step advances: ``pos`` and the self
        caches' lengths (the cross caches are read-only)."""
        pos = cache["pos"]
        out = [pos] if isinstance(pos, torch.Tensor) else []
        return out + [st.length for st in cache["self"]]

    # ----------------------------------------------------------------- encode
    def encode(self, params, frames: torch.Tensor, *, kv_block: int = 1024):
        """frames (B, S_enc, d_model): the stub's frame embeddings."""
        cfg = self.cfg
        S = frames.shape[1]
        x = frames.to(common.COMPUTE_DTYPE) + common.sinusoidal_positions(
            S, cfg.d_model, frames.device).to(common.COMPUTE_DTYPE)
        for p in params["enc_layers"]:
            h, _ = attention.attention_forward(
                p["attn"], common.layernorm(p["ln_attn"], x), cfg,
                causal=False, kv_block=kv_block)
            x = x + h
            x = x + ffn.ffn_apply(p["ffn"], common.layernorm(p["ln_ffn"], x),
                                  "gelu")
        return common.layernorm(params["ln_enc_final"], x)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        S = tokens.shape[1]
        x = params["embed"]["embedding"][tokens].to(common.COMPUTE_DTYPE)
        return x + params["dec_pos"][:S].to(common.COMPUTE_DTYPE)

    def _unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        x = common.layernorm(params["ln_dec_final"], x)
        return common.dense(params["unembed"], x).float()

    # ---------------------------------------------------------------- decode
    def _dec_layer(self, p, x, enc, *, self_cache=None, cross_cache=None,
                   kv_roundtrip=None, kv_block=1024):
        """Full-sequence decoder layer: (x, self cache, cross cache); the
        caches, if given, are filled (prefill)."""
        cfg = self.cfg
        h, self_cache = attention.attention_forward(
            p["self_attn"], common.layernorm(p["ln_self"], x), cfg,
            cache=self_cache, kv_roundtrip=kv_roundtrip, kv_block=kv_block)
        x = x + h
        h, cross_cache = attention.attention_forward(
            p["cross_attn"], common.layernorm(p["ln_cross"], x), cfg,
            cross_kv=enc, cache=cross_cache, kv_roundtrip=kv_roundtrip,
            kv_block=kv_block)
        x = x + h
        x = x + ffn.ffn_apply(p["ffn"], common.layernorm(p["ln_ffn"], x),
                              "gelu")
        return x, self_cache, cross_cache

    def forward(self, params, frames: torch.Tensor, tokens: torch.Tensor, *,
                rots: Optional[EncDecRotations] = None,
                kv_quant_cfg: Optional[dict] = None, remat: bool = False,
                kv_block: int = 1024) -> torch.Tensor:
        """Teacher-forced decoder logits (B, S_dec, V) fp32.  With
        ``kv_quant_cfg`` and ``rots``, a layer's self-attention rotations
        drive the round-trip hook of both its attentions, as the
        reference's do (``encdec.py:170-183``)."""
        hook = kv_quant_cfg is not None and rots is not None
        enc = self.encode(params, frames, kv_block=kv_block)
        x = self._embed(params, tokens)
        for i, p in enumerate(params["dec_layers"]):
            rt = (make_roundtrip(*rots.self_kv[i], **kv_quant_cfg)
                  if hook else None)

            def layer(x_, p=p, rt=rt):
                return self._dec_layer(p, x_, enc, kv_roundtrip=rt,
                                       kv_block=kv_block)[0]

            x = (torch.utils.checkpoint.checkpoint(layer, x,
                                                   use_reentrant=False)
                 if remat else layer(x))
        return self._unembed(params, x)

    def loss(self, params, batch: dict, *, remat: bool = False):
        """Next-token cross entropy of ``batch["tokens"]`` given
        ``batch["frames"]``: (loss, {"ce", "aux"}) with aux 0."""
        logits = self.forward(params, batch["frames"], batch["tokens"],
                              remat=remat)
        tokens = batch["tokens"]
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        loss = -lp.gather(-1, tokens[:, 1:, None].long())[..., 0].mean()
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        return loss, {"ce": loss, "aux": aux}

    # --------------------------------------------------------------- serving
    def prefill(self, params, frames: torch.Tensor, tokens: torch.Tensor,
                cache: dict, *, kv_block: int = 1024):
        """Encode the frames, write each layer's cross K/V once through the
        policy (B3 under int4), prefill the self caches: (last-token
        logits (B, 1, V) fp32, cache filled in place)."""
        enc = self.encode(params, frames, kv_block=kv_block)
        x = self._embed(params, tokens)
        for i, p in enumerate(params["dec_layers"]):
            x, cache["self"][i], cache["cross"][i] = self._dec_layer(
                p, x, enc, self_cache=cache["self"][i],
                cross_cache=cache["cross"][i], kv_block=kv_block)
        S = tokens.shape[1]
        pos = cache["pos"]
        cache["pos"] = S if isinstance(pos, int) else pos.fill_(S)
        return self._unembed(params, x[:, -1:]), cache

    def decode_step(self, params, token: torch.Tensor, cache: dict, *,
                    kv_block: int = 512, backend=None):
        """token (B, 1) -> (logits (B, 1, V) fp32, cache): the self caches
        are appended to, the cross caches only read (``policy.attend``)."""
        cfg = self.cfg
        pos = cache["pos"]
        x = params["embed"]["embedding"][token].to(common.COMPUTE_DTYPE)
        table = params["dec_pos"]
        x = x + (table[pos:pos + 1] if isinstance(pos, int)
                 else table.index_select(0, pos)[:, None]).to(
            common.COMPUTE_DTYPE)
        for i, p in enumerate(params["dec_layers"]):
            h, cache["self"][i] = attention.attention_decode(
                p["self_attn"], common.layernorm(p["ln_self"], x), cfg,
                cache["self"][i], position=pos, kv_block=kv_block,
                backend=backend)
            x = x + h
            h, _ = attention.attention_decode(
                p["cross_attn"], common.layernorm(p["ln_cross"], x), cfg,
                cache["cross"][i], cross=True, kv_block=kv_block,
                backend=backend)
            x = x + h
            x = x + ffn.ffn_apply(p["ffn"], common.layernorm(p["ln_ffn"], x),
                                  "gelu")
        if isinstance(pos, int):
            cache["pos"] = pos + 1
        else:
            pos.add_(1)
        return self._unembed(params, x), cache

    def decode_body(self, params, *, kv_block: int = 512, backend=None):
        """``(cache, token) -> (cache, logits)`` with the knobs closed
        over (the engine's loop body)."""

        def body(cache, token):
            logits, cache = self.decode_step(params, token, cache,
                                             kv_block=kv_block,
                                             backend=backend)
            return cache, logits

        return body
