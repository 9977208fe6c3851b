"""Decoder-only LM, the pure-attention families: dense, moe and vlm (port
of their branch of ``repro/models/lm.py``): ``init``, ``init_rotations``
(:132), ``init_cache`` (:155-217), the teacher-forced ``forward`` (:352-402),
``collect_kv`` (:404) and ``loss`` (:501) for training and the quality
measurements, and ``prefill``, ``prefill_chunk`` (:560-599, with
``_block_prefill_chunk``, :301), ``decode_step`` (:731-768),
``decode_body``, and the speculative ``decode_verify`` / ``truncate_cache``
(:678-729, with ``_block_verify``, :334) for serving.

A moe block's FFN is ``models/moe.py``'s routed experts; its
load-balancing loss comes out of :meth:`LM.forward_aux` (``forward`` keeps
returning the logits alone) and into :meth:`LM.loss`.  A vlm prompt may
start with patch embeddings (``patches=`` on ``forward``, ``collect_kv``
and ``prefill``), placed before the tokens; decode is text only.

The reference's ``lax.scan`` over stacked layers becomes a Python loop
over a list of per-layer parameter dicts and a list of per-layer cache
states; caches are preallocated and updated in place.  ``pos`` is a
Python int shared by every row or, in a ragged or paged slot cache
(continuous batching, and the single stream under a CUDA graph), a
per-row (B,) int32 tensor on the device, which every step updates in
place so that a captured step can be replayed.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache_api
from repro_torch.core.hooks import make_roundtrip
from repro_torch.core.transforms import Rotation, make_rotation
from repro_torch.models import attention, common, ffn, moe

__all__ = ["LM"]


class LM:
    """Functional model: params and caches are plain containers of tensors.

    ``device`` defaults to ``cuda`` and raises without a card; CPU runs
    pass ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"family={cfg.family} is not ported yet (ROADMAP A11: the "
                f"hybrid, ssm and audio families); the port serves dense, "
                f"moe and vlm")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the model's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def _block_init(self, g: torch.Generator) -> dict:
        cfg, dev = self.cfg, self.device
        p = {
            "ln_attn": common.rmsnorm_init(cfg.d_model, dev),
            "attn": attention.attention_init(g, cfg, dev),
            "ln_ffn": common.rmsnorm_init(cfg.d_model, dev),
        }
        if cfg.moe is not None:
            p["moe"] = moe.moe_init(g, cfg.d_model, cfg.moe, dev)
        else:
            p["ffn"] = ffn.ffn_init(g, cfg.d_model, cfg.d_ff,
                                    cfg.ffn_activation, dev)
        return p

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters; ``params["blocks"]`` is a per-layer list."""
        cfg, dev = self.cfg, self.device
        params: dict[str, Any] = {
            "embed": common.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                       dev),
            "ln_final": common.rmsnorm_init(cfg.d_model, dev),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = common.dense_init(
                generator, cfg.d_model, cfg.vocab_size, device=dev)
        params["blocks"] = [self._block_init(generator)
                            for _ in range(cfg.n_layers)]
        return params

    def init_rotations(self, generator: torch.Generator
                       ) -> Optional[list[tuple[Rotation, Rotation]]]:
        """Fresh unlearned rotations, one (k, v) pair per layer: the form
        ``init_cache(rots=...)`` and ``forward(rots=...)`` take.  None
        when the config does not quantize its KV cache."""
        cfg = self.cfg
        if not cfg.kv_quant:
            return None
        return [tuple(make_rotation(cfg.rotation, generator, cfg.head_dim,
                                    self.device) for _ in "kv")
                for _ in range(cfg.n_layers)]

    # ----------------------------------------------------------------- cache
    def cache_policy(self, policy=None):
        return cache_api.policy_from_config(self.cfg, policy)

    def init_cache(self, batch: int, s_max: int, *, policy=None,
                   rots: Optional[list[tuple[Rotation, Rotation]]] = None,
                   generator: Optional[torch.Generator] = None,
                   ragged: bool = False, n_pages: Optional[int] = None,
                   page_size: Optional[int] = None) -> dict:
        """Fresh serving cache: ``{"pos": 0, "attn": [CacheState] * L}``.
        Rotations come from ``generator`` or, given ``rots`` (one (k, v)
        pair per layer), are embedded as they are.

        ``ragged=True`` builds a continuous-batching slot cache: ``pos``
        and every state's length become per-row (B,) tensors.  ``n_pages``
        and ``page_size`` build a paged slot cache instead (needs
        ``ragged=True``): per-layer page pools behind per-row page tables,
        filled through ``insert_row_paged``."""
        cfg = self.cfg
        is_paged = n_pages is not None or page_size is not None
        if is_paged and (n_pages is None or page_size is None):
            raise ValueError("paged caches need both n_pages and page_size")
        if is_paged and not ragged:
            raise ValueError("paged caches are ragged by construction: "
                             "pass ragged=True")
        pol = self.cache_policy(policy)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        attn = []
        for i in range(cfg.n_layers):
            if is_paged:
                st = pol.init_paged(batch, cfg.n_kv_heads, s_max,
                                    cfg.head_dim, n_pages=n_pages,
                                    page_size=page_size, generator=generator,
                                    device=self.device)
            else:
                st = pol.init_state(batch, cfg.n_kv_heads, s_max,
                                    cfg.head_dim, generator=generator,
                                    device=self.device, ragged=ragged)
            if rots is not None:
                st = pol.with_rotations(st, *rots[i])
            attn.append(st)
        pos = (torch.zeros((batch,), dtype=torch.int32, device=self.device)
               if ragged else 0)
        return {"pos": pos, "attn": attn}

    # ------------------------------------------------------------- embedding
    def _embed(self, params, tokens: torch.Tensor,
               patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings (B, S, d) bf16; a vlm's ``patches`` (B, P, d)
        go first (prefill and training; decode steps are text only)."""
        cfg = self.cfg
        x = params["embed"]["embedding"][tokens].to(common.COMPUTE_DTYPE)
        if cfg.embed_scale:
            x = x * torch.tensor(float(cfg.d_model)).sqrt().to(x.dtype)
        if cfg.family == "vlm" and patches is not None:
            x = torch.cat([patches.to(common.COMPUTE_DTYPE), x], dim=1)
        return x

    def _unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = common.rmsnorm(params["ln_final"], x, eps=cfg.norm_eps)
        if cfg.tie_embeddings:
            return common.matmul(x, params["embed"]["embedding"].T)
        return common.dense(params["unembed"], x).float()

    # ---------------------------------------------------------- block bodies
    def _ffn(self, p, x):
        """The block's FFN half: (x + FFN(norm(x)), aux), aux the MoE
        load-balancing loss (0.0 for a dense FFN)."""
        cfg = self.cfg
        h_in = common.rmsnorm(p["ln_ffn"], x, eps=cfg.norm_eps)
        if cfg.moe is not None:
            h, aux = moe.moe_apply(p["moe"], h_in, cfg.moe)
            return x + h, aux
        return x + ffn.ffn_apply(p["ffn"], h_in, cfg.ffn_activation), 0.0

    def _block_full(self, p, x, cache=None, *, kv_roundtrip=None,
                    kv_block=1024, return_kv=False):
        """Full-sequence block (train, eval, prefill): (x, aux, cache),
        plus the layer's (k, v) with ``return_kv``."""
        out = attention.attention_forward(
            p["attn"], common.rmsnorm(p["ln_attn"], x, eps=self.cfg.norm_eps),
            self.cfg, cache=cache, kv_block=kv_block,
            kv_roundtrip=kv_roundtrip, return_kv=return_kv)
        return (*self._ffn(p, x + out[0]), *out[1:])

    def _block_prefill_chunk(self, p, x, cache, raw_k, raw_v, *, offset,
                             kv_block=1024):
        h, cache = attention.attention_prefill_chunk(
            p["attn"], common.rmsnorm(p["ln_attn"], x, eps=self.cfg.norm_eps),
            self.cfg, cache, raw_k, raw_v, offset=offset, kv_block=kv_block)
        return self._ffn(p, x + h)[0], cache

    def _block_decode(self, p, x, cache, *, position, kv_block=512,
                      backend=None, active=None):
        h, cache = attention.attention_decode(
            p["attn"], common.rmsnorm(p["ln_attn"], x, eps=self.cfg.norm_eps),
            self.cfg, cache, position=position, kv_block=kv_block,
            backend=backend, active=active)
        return self._ffn(p, x + h)[0], cache

    def _block_verify(self, p, x, cache, *, position, kv_block=512,
                      backend=None, active=None, snap=None):
        h, cache, snap = attention.attention_verify(
            p["attn"], common.rmsnorm(p["ln_attn"], x, eps=self.cfg.norm_eps),
            self.cfg, cache, position=position, kv_block=kv_block,
            backend=backend, active=active, snap=snap)
        return self._ffn(p, x + h)[0], cache, snap

    # ------------------------------------------------------- full sequence
    def forward(self, params, tokens: torch.Tensor, *,
                patches: Optional[torch.Tensor] = None,
                rots: Optional[list[tuple[Rotation, Rotation]]] = None,
                kv_quant_cfg: Optional[dict] = None, remat: bool = False,
                kv_block: int = 1024) -> torch.Tensor:
        """Teacher-forced logits (B, P + S, V) fp32 (P patches, vlm only).
        ``kv_quant_cfg`` = {bits, scheme, group} with ``rots`` (one (k, v)
        pair per layer) turns on the paper's KV round-trip hook.
        ``remat`` recomputes each block in the backward pass
        (``torch.utils.checkpoint``).  :meth:`forward_aux` also returns
        the MoE load-balancing loss."""
        return self.forward_aux(params, tokens, patches=patches, rots=rots,
                                kv_quant_cfg=kv_quant_cfg, remat=remat,
                                kv_block=kv_block)[0]

    def forward_aux(self, params, tokens: torch.Tensor, *,
                    patches: Optional[torch.Tensor] = None,
                    rots: Optional[list[tuple[Rotation, Rotation]]] = None,
                    kv_quant_cfg: Optional[dict] = None, remat: bool = False,
                    kv_block: int = 1024):
        """:meth:`forward`'s (logits, aux): aux is the sum over layers of
        the MoE load-balancing loss, a 0-d fp32 tensor (0 without MoE),
        as the reference's ``forward`` returns it (``lm.py:352-402``)."""
        hook = kv_quant_cfg is not None and rots is not None
        x = self._embed(params, tokens, patches)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, p in enumerate(params["blocks"]):
            rt = make_roundtrip(*rots[i], **kv_quant_cfg) if hook else None

            def block(p_, x_, rt=rt):
                return self._block_full(p_, x_, kv_roundtrip=rt,
                                        kv_block=kv_block)[:2]

            x, a = (torch.utils.checkpoint.checkpoint(block, p, x,
                                                      use_reentrant=False)
                    if remat else block(p, x))
            aux = aux + a
        return self._unembed(params, x), aux

    def collect_kv(self, params, tokens: torch.Tensor, *,
                   patches: Optional[torch.Tensor] = None,
                   kv_block: int = 1024):
        """Per-layer raw K/V activations, (k, v) each (L, B, Hkv, S, d):
        the calibration-data pass."""
        x = self._embed(params, tokens, patches)
        ks, vs = [], []
        for p in params["blocks"]:
            x, _, _, (k, v) = self._block_full(p, x, kv_block=kv_block,
                                               return_kv=True)
            ks.append(k)
            vs.append(v)
        return torch.stack(ks), torch.stack(vs)

    def loss(self, params, batch: dict, *, remat: bool = False):
        """Mean next-token cross entropy of ``batch["tokens"]`` (B, S) over
        the text positions (a vlm's ``batch["patches"]`` (B, P, d) are
        dropped from the logits) plus 0.01 x the MoE aux loss: (total,
        {"ce", "aux"}) (ref ``lm.py:501-524``, without its loss mask, which
        no data pipeline here produces)."""
        tokens = batch["tokens"]
        patches = batch.get("patches")
        logits, aux = self.forward_aux(params, tokens, patches=patches,
                                       remat=remat)
        if self.cfg.family == "vlm" and patches is not None:
            logits = logits[:, patches.shape[1]:]
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -lp.gather(-1, tokens[:, 1:, None].long())[..., 0]
        loss = nll.mean()
        total = loss if self.cfg.moe is None else loss + 0.01 * aux
        return total, {"ce": loss, "aux": aux}

    # --------------------------------------------------------------- serving
    def prefill(self, params, tokens: torch.Tensor, cache: dict, *,
                patches: Optional[torch.Tensor] = None,
                kv_block: int = 1024):
        """tokens (B, S) -> (last-token logits (B, 1, V) fp32, cache).  A
        vlm's ``patches`` (B, P, d) fill the first P positions."""
        x = self._embed(params, tokens, patches)
        for i, p in enumerate(params["blocks"]):
            x, _, cache["attn"][i] = self._block_full(
                p, x, cache["attn"][i], kv_block=kv_block)
        S = x.shape[1]
        pos = cache["pos"]
        cache["pos"] = S if isinstance(pos, int) else pos.fill_(S)
        return self._unembed(params, x[:, -1:]), cache

    def prefill_chunk(self, params, tokens: torch.Tensor, cache: dict,
                      raw_k: torch.Tensor, raw_v: torch.Tensor, *,
                      kv_block: int = 1024):
        """One C-token slice (B, C) of a prompt (chunked prefill): appended
        at ``cache["pos"]``, the tokens a ragged (batch-1) cache already
        holds.  ``raw_k`` / ``raw_v`` are (n_layers, B, Hkv, S_prompt, hd)
        bf16 side buffers of the raw K/V so far, written in place; the
        chunk's queries attend them, so a chain of chunks gives a
        monolithic :meth:`prefill`'s logits and cache bytes.  Returns (the
        chunk's last-token logits (B, 1, V) fp32, cache, raw_k, raw_v)."""
        pos = cache["pos"]
        if isinstance(pos, int):
            raise ValueError("chunked prefill needs a ragged cache "
                             "(init_cache(..., ragged=True))")
        offset = pos[0].clone()  # rows advance in lockstep
        x = self._embed(params, tokens)
        for i, p in enumerate(params["blocks"]):
            x, cache["attn"][i] = self._block_prefill_chunk(
                p, x, cache["attn"][i], raw_k[i], raw_v[i], offset=offset,
                kv_block=kv_block)
        pos.add_(tokens.shape[1])
        return self._unembed(params, x[:, -1:]), cache, raw_k, raw_v

    def decode_step(self, params, token: torch.Tensor, cache: dict, *,
                    kv_block: int = 512, backend=None, active=None):
        """token (B, 1) -> (logits (B, 1, V) fp32, cache).  ``backend``
        (AttendBackend or its value) picks the read path; None = GATHER.

        A ragged cache decodes every row at its own position; ``active``
        (B,) bool masks finished rows: their length and position stand
        still and their logits are meaningless."""
        pos = cache["pos"]
        if active is not None and isinstance(pos, int):
            raise ValueError("active masks need a ragged cache "
                             "(init_cache(..., ragged=True))")
        x = self._embed(params, token)
        for i, p in enumerate(params["blocks"]):
            x, cache["attn"][i] = self._block_decode(
                p, x, cache["attn"][i], position=pos, kv_block=kv_block,
                backend=backend, active=active)
        if isinstance(pos, int):
            cache["pos"] = pos + 1
        else:
            pos.add_(1 if active is None else active.to(pos.dtype))
        return self._unembed(params, x), cache

    def decode_verify(self, params, tokens: torch.Tensor, cache: dict, *,
                      kv_block: int = 512, backend=None, active=None,
                      snaps=None):
        """Speculative verify pass: ``tokens`` (B, k) is the current token
        and k - 1 drafts.  Appends all k to the cache (in place; ``pos``
        advances by k, or by k where ``active``) and scores them in one
        pass.  Returns (logits (B, k, V) fp32, cache, snaps), where
        ``logits[:, j]`` are the logits a sequential :meth:`decode_step`
        gives token j and ``snaps`` the per-layer ``snapshot_rows`` that
        :meth:`truncate_cache` rolls back with; given ``snaps`` (a
        previous pass's), this pass's snapshots are copied into them."""
        pos = cache["pos"]
        if active is not None and isinstance(pos, int):
            raise ValueError("active masks need a ragged cache "
                             "(init_cache(..., ragged=True))")
        kq = tokens.shape[1]
        x = self._embed(params, tokens)
        out = []
        for i, p in enumerate(params["blocks"]):
            x, cache["attn"][i], snap = self._block_verify(
                p, x, cache["attn"][i], position=pos, kv_block=kv_block,
                backend=backend, active=active,
                snap=None if snaps is None else snaps[i])
            out.append(snap)
        if isinstance(pos, int):
            cache["pos"] = pos + kq
        else:
            pos.add_(kq if active is None else active.to(pos.dtype) * kq)
        return self._unembed(params, x), cache, out

    def truncate_cache(self, cache: dict, new_length, snaps) -> dict:
        """Roll a :meth:`decode_verify` pass back to ``new_length`` (a
        shared int, or per-row (B,): entry length + tokens kept), in
        place: every layer's ``policy.truncate_rows``, ``pos`` set to the
        same lengths."""
        for st, snap in zip(cache["attn"], snaps):
            st.policy.truncate_rows(st, new_length, snap)
        pos = cache["pos"]
        if isinstance(pos, int):
            cache["pos"] = int(new_length)
        else:
            pos.copy_(torch.as_tensor(new_length).expand(pos.shape))
        return cache

    def decode_body(self, params, *, kv_block: int = 512, backend=None):
        """``(cache, token) -> (cache, logits)`` with the knobs closed over
        (the engine's loop body)."""

        def body(cache, token):
            logits, cache = self.decode_step(params, token, cache,
                                             kv_block=kv_block,
                                             backend=backend)
            return cache, logits

        return body
