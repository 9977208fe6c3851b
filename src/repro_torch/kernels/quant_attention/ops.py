"""Wrapper for kernel B1, the int4 flash-decode read (port of
``repro/kernels/quant_attention/ops.py:22``).

``decode_attention_kernel`` folds ``folded_query_matrix()·scale`` into q,
flattens to ``(B·Hkv, G, d)`` rows, runs :func:`quant_decode_attention`
and applies ``rot_v.inverse`` to the one output vector.  On a CPU tensor
that runs the plain version (``ref.py``); on a CUDA tensor it launches
``csrc/quant_attention.cu`` (split-K pass + combine pass) or raises.
``launches`` counts wrapper calls that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import kvcache as kvc
from repro_torch.kernels import _build
from repro_torch.kernels.quant_attention.ref import (
    quant_decode_attention_ref,
    row_lengths,
)

__all__ = ["quant_decode_attention", "decode_attention_kernel", "launches",
           "TILE"]

TILE = 64  # tokens per tile in csrc/quant_attention.cu (kTile)
launches = 0  # kernel launches since the caller last set this to 0
_FN = None
_SMS: dict[int, int] = {}


def _fn():
    global _FN
    if _FN is None:
        lib = _build.library("quant_attention")
        fn = lib.quant_decode_attention_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 9 + [I, I] + [P] * 3 + [I] * 8 + [P]
        fn.restype = I
        _FN = (lib, fn)
    return _FN


def split_plan(rows: int, n_tiles: int, sms: int,
               max_splits: int) -> tuple[int, int]:
    """(n_splits, tiles_per_split): about four blocks per SM, at most
    ``max_splits``, no empty split."""
    if n_tiles == 0:
        return 1, 0
    want = max(1, min(max_splits, -(-4 * sms // max(rows, 1))))
    tps = -(-n_tiles // min(n_tiles, want))
    return -(-n_tiles // tps), tps


# pass 2 stages every split's partials in shared memory: keep it < 192 KiB
_COMBINE_WORDS = 48 * 1024


def _lengths(x, rows, device):
    """int -> (scalar, None); tensor -> (0, per-row int32 (rows,) on device)."""
    if isinstance(x, int):
        return x, None
    return 0, row_lengths(x, rows, device).contiguous()


def _launch(q_eff, kp, ks, vp, vs, kr, vr, packed_len, total_len, group):
    global launches
    BH, G, d = q_eff.shape
    S, W = kp.shape[1], kr.shape[1]
    dev = q_eff.device
    expect = {
        "q_eff": (q_eff, torch.float32, (BH, G, d)),
        "k_packed": (kp, torch.uint8, (BH, S, d // 2)),
        "v_packed": (vp, torch.uint8, (BH, S, d // 2)),
        "k_scales": (ks, torch.float32, (BH, S, d // group)),
        "v_scales": (vs, torch.float32, (BH, S, d // group)),
        "k_residual": (kr, torch.float32, (BH, W, d)),
        "v_residual": (vr, torch.float32, (BH, W, d)),
    }
    for name, (t, dt, shape) in expect.items():
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need contiguous {dt} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if G > 8 or d > 256 or d % 8 or d % group:
        raise ValueError(f"unsupported G={G} d={d} group={group}")
    plen, plen_rows = _lengths(packed_len, BH, dev)
    tlen, tlen_rows = _lengths(total_len, BH, dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    n_tiles = -(-(plen if plen_rows is None else S) // TILE)
    max_splits = max(1, (_COMBINE_WORDS - 2 * W * d - G * W - 3 * G)
                     // (G * (d + 3)))
    n_splits, tps = split_plan(BH, n_tiles, _SMS[idx], max_splits)
    part_ml = torch.empty((BH, n_splits, G, 2), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((BH, n_splits, G, d), dtype=torch.float32,
                           device=dev)
    out = torch.empty((BH, G, d), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib, fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q_eff.data_ptr(), kp.data_ptr(), ks.data_ptr(),
                vp.data_ptr(), vs.data_ptr(), kr.data_ptr(), vr.data_ptr(),
                ptr(plen_rows), ptr(tlen_rows), plen, tlen,
                part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                BH, S, G, d, group, W, n_splits, tps, stream)
    _build.check(lib, "quant_attention", rc)
    launches += 1
    return out


def quant_decode_attention(q_eff, k_packed, k_scales, v_packed, v_scales,
                           k_residual, v_residual, packed_len, total_len, *,
                           group: int = 32, blk: int = 256) -> torch.Tensor:
    """out_rot (BH, G, d) f32; arguments as ``ref.quant_decode_attention_ref``.

    ``blk`` is the plain version's tile (the reference kernel's); the CUDA
    kernel tiles by :data:`TILE` tokens and splits the sequence itself."""
    if q_eff.device.type == "cpu":
        return quant_decode_attention_ref(
            q_eff, k_packed, k_scales, v_packed, v_scales, k_residual,
            v_residual, packed_len, total_len, group=group, blk=blk)
    if q_eff.device.type != "cuda":
        raise ValueError(f"quant_decode_attention runs on cpu or cuda, not "
                         f"{q_eff.device}")
    return _launch(q_eff, k_packed, k_scales, v_packed, v_scales, k_residual,
                   v_residual, packed_len, total_len, group)


def decode_attention_kernel(q: torch.Tensor, cache, rot_k, rot_v, *,
                            scale: float | None = None, blk: int = 256
                            ) -> torch.Tensor:
    """(B, Hq, 1, d) decode attention output in the original basis."""
    B, Hq, _, d = q.shape
    Hkv = cache.k_packed.shape[1]
    G = Hq // Hkv
    sm = scale if scale is not None else d ** -0.5
    q_eff = (q.float() @ rot_k.folded_query_matrix().T) * sm
    q_eff = q_eff.reshape(B * Hkv, G, d).contiguous()

    def flat(x):
        return x.reshape(B * Hkv, *x.shape[2:])

    out_rot = quant_decode_attention(
        q_eff, flat(cache.k_packed), flat(cache.k_scales),
        flat(cache.v_packed), flat(cache.v_scales),
        flat(cache.k_residual), flat(cache.v_residual),
        kvc.packed_len(cache), cache.length, group=cache.group, blk=blk,
    )
    return rot_v.inverse(out_rot.reshape(B, Hq, 1, d)).to(q.dtype)
