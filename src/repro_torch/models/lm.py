"""Decoder-only LM: the pure-attention families (dense, moe, vlm), the
hybrid (zamba2: Mamba2 blocks and one shared attention block) and the ssm
family (xlstm: mLSTM and sLSTM blocks) (port of ``repro/models/lm.py``):
``init`` (:74-120), ``n_attn_layers`` (:124-130), ``init_rotations``
(:132), ``init_cache`` (:155-239), the teacher-forced ``forward``
(:352-402, with ``_hybrid_forward`` :430 and ``_xlstm_forward`` :472),
``collect_kv`` (:404) and ``loss`` (:501) for training and the quality
measurements, and ``prefill`` (:526-632, with ``_hybrid_prefill`` and
``_xlstm_prefill``), ``prefill_chunk`` (:560-599, with
``_block_prefill_chunk``, :301), ``decode_step`` (:731-826),
``decode_body``, and the speculative ``decode_verify`` /
``truncate_cache`` (:678-729, with ``_block_verify``, :334) for serving.

A moe block's FFN is ``models/moe.py``'s routed experts; its
load-balancing loss comes out of :meth:`LM.forward_aux` (``forward`` keeps
returning the logits alone) and into :meth:`LM.loss`.  A vlm prompt may
start with patch embeddings (``patches=`` on ``forward``, ``collect_kv``
and ``prefill``), placed before the tokens; decode is text only.

The hybrid runs groups of P Mamba2 blocks, each group followed by the one
shared attention block (the same weights at every firing, never copied;
one cache and one rotation pair per firing), then the trailing blocks;
the ssm family runs groups of P - 1 mLSTM blocks and one sLSTM block.
Their recurrent states live in the cache (``ssm_super`` / ``ssm_rem``,
``mlstm`` / ``slstm``); an xlstm cache has no ``attn``.

The reference's ``lax.scan`` over stacked layers becomes a Python loop
over lists of per-layer parameter dicts and of per-layer cache states;
caches are preallocated and updated in place, the recurrent states by
``copy_`` into their tensors.  ``pos`` is a Python int shared by every
row or, in a ragged or paged slot cache (continuous batching, and the
single stream under a CUDA graph), a per-row (B,) int32 tensor on the
device, which every step updates in place so that a captured step can be
replayed.

The recurrent families keep their length on the device the same way: the
reference refuses ``ragged=True`` for them (``lm.py:185-190``), the port
accepts it with every row at one length, which is what a captured decode
step needs.  Admission at different lengths (``BatchEngine``), paged
caches, ``prefill_chunk``, ``decode_verify`` and ``active`` masks raise
for them, as the reference's do.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ATTENTION_FAMILIES, ModelConfig
from repro_torch.core import cache_api
from repro_torch.core.hooks import make_roundtrip
from repro_torch.core.transforms import Rotation, make_rotation
from repro_torch.models import attention, common, ffn, moe, ssm, xlstm

__all__ = ["LM"]


def _assign(dst, src) -> None:
    """Copy a new recurrent state into the cache's tensors, in place."""
    for a, b in zip(dst, src):
        a.copy_(b)


def _require_attention_family(family: str, what: str) -> None:
    if family not in ATTENTION_FAMILIES:
        raise NotImplementedError(
            f"{what} needs a pure-attention family (got {family}: "
            f"recurrent state has no per-row lengths and no rollback)")


class LM:
    """Functional model: params and caches are plain containers of tensors.

    ``device`` defaults to ``cuda`` and raises without a card; CPU runs
    pass ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        if cfg.family not in ATTENTION_FAMILIES + ("hybrid", "ssm"):
            raise ValueError(
                f"LM takes the dense, moe, vlm, hybrid and ssm families "
                f"(got {cfg.family}); build an audio model with "
                f"models.build_model (EncDec)")
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

    def _rec_block_init(self, g: torch.Generator, name: str, init_fn):
        return {"ln": common.rmsnorm_init(self.cfg.d_model, self.device),
                name: init_fn(g, self.cfg, self.device)}

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters.  ``params["blocks"]`` is a per-layer list
        (dense, moe, vlm); a hybrid has ``mamba_super`` (n_super lists of
        P blocks), ``mamba_rem`` (the trailing blocks, if any) and one
        ``shared_attn`` block; an ssm model ``mlstm_super`` (n_super lists
        of P - 1 blocks) and ``slstm`` (n_super blocks)."""
        cfg, dev, g = self.cfg, self.device, generator
        params: dict[str, Any] = {
            "embed": common.embed_init(g, cfg.vocab_size, cfg.d_model, dev),
            "ln_final": common.rmsnorm_init(cfg.d_model, dev),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = common.dense_init(
                g, cfg.d_model, cfg.vocab_size, device=dev)
        if cfg.family in ATTENTION_FAMILIES:
            params["blocks"] = [self._block_init(g)
                                for _ in range(cfg.n_layers)]
        elif cfg.family == "hybrid":
            P, n_super, rem = self._hybrid_shape()
            params["mamba_super"] = [
                [self._rec_block_init(g, "mamba", ssm.mamba2_init)
                 for _ in range(P)] for _ in range(n_super)]
            if rem:
                params["mamba_rem"] = [
                    self._rec_block_init(g, "mamba", ssm.mamba2_init)
                    for _ in range(rem)]
            params["shared_attn"] = self._block_init(g)  # one copy
        else:  # ssm
            P, n_super = self._xlstm_shape()
            params["mlstm_super"] = [
                [self._rec_block_init(g, "mlstm", xlstm.mlstm_init)
                 for _ in range(P - 1)] for _ in range(n_super)]
            params["slstm"] = [
                self._rec_block_init(g, "slstm", xlstm.slstm_init)
                for _ in range(n_super)]
        return params

    def _hybrid_shape(self) -> tuple[int, int, int]:
        """(P, n_super, rem): groups of P Mamba2 blocks, each followed by
        the shared attention block, then ``rem`` trailing blocks."""
        P = self.cfg.shared_attn_period
        n_super = self.cfg.n_layers // P
        return P, n_super, self.cfg.n_layers - n_super * P

    def _xlstm_shape(self) -> tuple[int, int]:
        P = self.cfg.xlstm.slstm_period
        n_super = self.cfg.n_layers // P
        if n_super * P != self.cfg.n_layers:
            raise ValueError(f"n_layers={self.cfg.n_layers} is no multiple "
                             f"of slstm_period={P}")
        return P, n_super

    @property
    def n_attn_layers(self) -> int:
        """Attention layers with a cache: every layer of a pure-attention
        family, one per shared-block firing of a hybrid, none for ssm."""
        cfg = self.cfg
        if cfg.family in ATTENTION_FAMILIES:
            return cfg.n_layers
        if cfg.family == "hybrid":
            return cfg.n_layers // cfg.shared_attn_period
        return 0

    def init_rotations(self, generator: torch.Generator
                       ) -> Optional[list[tuple[Rotation, Rotation]]]:
        """Fresh unlearned rotations, one (k, v) pair per attention layer
        (a hybrid: per firing of the shared block): the form
        ``init_cache(rots=...)`` and ``forward(rots=...)`` take.  None
        when the config does not quantize its KV cache or has none."""
        cfg = self.cfg
        if not cfg.kv_quant or not self.n_attn_layers:
            return None
        return [tuple(make_rotation(cfg.rotation, generator, cfg.head_dim,
                                    self.device) for _ in "kv")
                for _ in range(self.n_attn_layers)]

    # ----------------------------------------------------------------- cache
    def cache_policy(self, policy=None):
        return cache_api.policy_from_config(self.cfg, policy)

    def init_cache(self, batch: int, s_max: int, *, policy=None,
                   rots: Optional[list[tuple[Rotation, Rotation]]] = None,
                   generator: Optional[torch.Generator] = None,
                   ragged: bool = False, n_pages: Optional[int] = None,
                   page_size: Optional[int] = None) -> dict:
        """Fresh serving cache: ``{"pos": 0, "attn": [CacheState] *
        n_attn_layers}``, plus a hybrid's ``ssm_super`` / ``ssm_rem`` and
        an ssm model's ``mlstm`` / ``slstm`` recurrent states (an ssm
        cache has no ``attn``).  Rotations come from ``generator`` or,
        given ``rots`` (one (k, v) pair per attention layer), are embedded
        as they are.

        ``ragged=True`` builds a continuous-batching slot cache: ``pos``
        and every state's length become per-row (B,) tensors (for a
        recurrent family: device lengths, every row at one length).
        ``n_pages`` and ``page_size`` build a paged slot cache instead
        (needs ``ragged=True`` and a pure-attention family): per-layer
        page pools behind per-row page tables, filled through
        ``insert_row_paged``."""
        cfg, dev = self.cfg, self.device
        is_paged = n_pages is not None or page_size is not None
        if is_paged and (n_pages is None or page_size is None):
            raise ValueError("paged caches need both n_pages and page_size")
        if is_paged and not ragged:
            raise ValueError("paged caches are ragged by construction: "
                             "pass ragged=True")
        if is_paged:
            _require_attention_family(cfg.family, "a paged slot cache")
        pos = (torch.zeros((batch,), dtype=torch.int32, device=dev)
               if ragged else 0)
        cache: dict[str, Any] = {"pos": pos}
        if cfg.family == "hybrid":
            P, n_super, rem = self._hybrid_shape()
            cache["ssm_super"] = [[ssm.init_ssm_state(cfg, batch, dev)
                                   for _ in range(P)]
                                  for _ in range(n_super)]
            if rem:
                cache["ssm_rem"] = [ssm.init_ssm_state(cfg, batch, dev)
                                    for _ in range(rem)]
        elif cfg.family == "ssm":
            P, n_super = self._xlstm_shape()
            cache["mlstm"] = [[xlstm.init_mlstm_state(cfg, batch, dev)
                               for _ in range(P - 1)]
                              for _ in range(n_super)]
            cache["slstm"] = [xlstm.init_slstm_state(cfg, batch, dev)
                              for _ in range(n_super)]
            return cache
        pol = self.cache_policy(policy)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        attn = []
        for i in range(self.n_attn_layers):
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
        cache["attn"] = attn
        return cache

    def recurrent_states(self, cache: dict) -> list:
        """The cache's recurrent states (SSMState, MLSTMState,
        SLSTMState), in layer order; empty for a pure-attention family."""
        out = []
        for key in ("ssm_super", "ssm_rem", "mlstm", "slstm"):
            for st in cache.get(key, ()):
                out.extend(st if isinstance(st, list) else [st])
        return out

    def step_state(self, cache: dict) -> list:
        """The tensors a decode step advances: ``pos``, every attention
        state's length, every recurrent state's tensors.  A captured step
        is warmed up once and these are put back (``launch/graphs.py``)."""
        pos = cache["pos"]
        out = [pos] if isinstance(pos, torch.Tensor) else []
        out += [st.length for st in cache.get("attn", ())]
        for st in self.recurrent_states(cache):
            out.extend(st)
        return out

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

    def _rec(self, p, x, name: str, fn, state=None):
        """A recurrent block (Mamba2, mLSTM or sLSTM): x + fn(norm(x)),
        ``fn`` its full-sequence or its one-token function; ``state`` (the
        cache's) is advanced in place."""
        y, new = fn(p[name], common.rmsnorm(p["ln"], x,
                                            eps=self.cfg.norm_eps),
                    self.cfg, state)
        if state is not None:
            _assign(state, new)
        return x + y

    def _serve_recurrent(self, params, x, cache, full: bool, attend):
        """A hybrid's or an ssm model's blocks over their cache, a prefill
        (``full``) or a decode step; ``attend(p, x, state) -> (x, state)``
        runs the shared attention block of a hybrid's firing."""
        if self.cfg.family == "hybrid":
            mamba = ssm.mamba2_forward if full else ssm.mamba2_decode
            for i, (mparams, states) in enumerate(
                    zip(params["mamba_super"], cache["ssm_super"])):
                for p, st in zip(mparams, states):
                    x = self._rec(p, x, "mamba", mamba, st)
                x, cache["attn"][i] = attend(params["shared_attn"], x,
                                             cache["attn"][i])
            for p, st in zip(params.get("mamba_rem", ()),
                             cache.get("ssm_rem", ())):
                x = self._rec(p, x, "mamba", mamba, st)
            return x
        mlstm, slstm = ((xlstm.mlstm_forward, xlstm.slstm_forward) if full
                        else (xlstm.mlstm_decode, xlstm.slstm_decode))
        for mparams, states, sp, sst in zip(
                params["mlstm_super"], cache["mlstm"], params["slstm"],
                cache["slstm"]):
            for p, st in zip(mparams, states):
                x = self._rec(p, x, "mlstm", mlstm, st)
            x = self._rec(sp, x, "slstm", slstm, sst)
        return x

    def _hybrid_forward(self, params, x, rots, kv_quant_cfg, remat,
                        kv_block):
        """Training / eval stack of a hybrid (ref ``lm.py:430-467``); a
        firing of the shared block gets its own round-trip hook."""
        hook = kv_quant_cfg is not None and rots is not None
        for i, mparams in enumerate(params["mamba_super"]):
            rt = make_roundtrip(*rots[i], **kv_quant_cfg) if hook else None

            def group(x_, mparams=mparams, rt=rt):
                for p in mparams:
                    x_ = self._rec(p, x_, "mamba", ssm.mamba2_forward)
                return self._block_full(params["shared_attn"], x_,
                                        kv_roundtrip=rt,
                                        kv_block=kv_block)[0]

            x = (torch.utils.checkpoint.checkpoint(group, x,
                                                   use_reentrant=False)
                 if remat else group(x))
        for p in params.get("mamba_rem", ()):
            x = self._rec(p, x, "mamba", ssm.mamba2_forward)
        return x

    def _xlstm_forward(self, params, x, remat):
        """Training / eval stack of an xlstm (ref ``lm.py:472-499``)."""
        for mparams, sp in zip(params["mlstm_super"], params["slstm"]):
            def group(x_, mparams=mparams, sp=sp):
                for p in mparams:
                    x_ = self._rec(p, x_, "mlstm", xlstm.mlstm_forward)
                return self._rec(sp, x_, "slstm", xlstm.slstm_forward)

            x = (torch.utils.checkpoint.checkpoint(group, x,
                                                   use_reentrant=False)
                 if remat else group(x))
        return x

    # ------------------------------------------------------- full sequence
    def forward(self, params, tokens: torch.Tensor, *,
                patches: Optional[torch.Tensor] = None,
                rots: Optional[list[tuple[Rotation, Rotation]]] = None,
                kv_quant_cfg: Optional[dict] = None, remat: bool = False,
                kv_block: int = 1024) -> torch.Tensor:
        """Teacher-forced logits (B, P + S, V) fp32 (P patches, vlm only).
        ``kv_quant_cfg`` = {bits, scheme, group} with ``rots`` (one (k, v)
        pair per attention layer) turns on the paper's KV round-trip hook.
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
        if self.cfg.family == "hybrid":
            x = self._hybrid_forward(params, x, rots, kv_quant_cfg, remat,
                                     kv_block)
        elif self.cfg.family == "ssm":
            x = self._xlstm_forward(params, x, remat)
        for i, p in enumerate(params.get("blocks", ())):
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
        the calibration-data pass (pure-attention families)."""
        if self.cfg.family not in ATTENTION_FAMILIES:
            raise ValueError(f"collect_kv runs the pure-attention families "
                             f"(got {self.cfg.family})")
        x = self._embed(params, tokens, patches)
        ks, vs = [], []
        for p in params["blocks"]:
            x, _, _, (k, v) = self._block_full(p, x, kv_block=kv_block,
                                               return_kv=True)
            ks.append(k)
            vs.append(v)
        return torch.stack(ks), torch.stack(vs)

    def loss(self, params, batch: dict, *, remat: bool = False):
        """Next-token cross entropy of ``batch["tokens"]`` (B, S) over the
        text positions (a vlm's ``batch["patches"]`` (B, P, d) are dropped
        from the logits) plus 0.01 x the MoE aux loss: (total, {"ce",
        "aux"}) (ref ``lm.py:501-524``).  With ``batch["loss_mask"]`` (B, S)
        the cross entropy is the masked mean, each target position t >= 1
        weighted by ``mask[:, t]``: sum(nll * mask[:, 1:]) /
        max(sum(mask[:, 1:]), 1); without one, the plain mean."""
        tokens = batch["tokens"]
        patches = batch.get("patches")
        logits, aux = self.forward_aux(params, tokens, patches=patches,
                                       remat=remat)
        if self.cfg.family == "vlm" and patches is not None:
            logits = logits[:, patches.shape[1]:]
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -lp.gather(-1, tokens[:, 1:, None].long())[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            loss = nll.mean()
        else:
            mask = mask[:, 1:].float()
            loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        total = loss if self.cfg.moe is None else loss + 0.01 * aux
        return total, {"ce": loss, "aux": aux}

    # --------------------------------------------------------------- serving
    def prefill(self, params, tokens: torch.Tensor, cache: dict, *,
                patches: Optional[torch.Tensor] = None,
                kv_block: int = 1024):
        """tokens (B, S) -> (last-token logits (B, 1, V) fp32, cache).  A
        vlm's ``patches`` (B, P, d) fill the first P positions."""
        x = self._embed(params, tokens, patches)
        if self.cfg.family not in ATTENTION_FAMILIES:
            def attend(p, x_, st):
                x_, _, st = self._block_full(p, x_, st, kv_block=kv_block)
                return x_, st

            x = self._serve_recurrent(params, x, cache, True, attend)
        for i, p in enumerate(params.get("blocks", ())):
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
        _require_attention_family(self.cfg.family, "chunked prefill")
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
        if active is not None:
            _require_attention_family(self.cfg.family, "an active mask")
        if active is not None and isinstance(pos, int):
            raise ValueError("active masks need a ragged cache "
                             "(init_cache(..., ragged=True))")
        x = self._embed(params, token)
        if self.cfg.family not in ATTENTION_FAMILIES:
            def attend(p, x_, st):
                return self._block_decode(p, x_, st, position=pos,
                                          kv_block=kv_block, backend=backend)

            x = self._serve_recurrent(params, x, cache, False, attend)
        for i, p in enumerate(params.get("blocks", ())):
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
        _require_attention_family(self.cfg.family, "speculative verify")
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
