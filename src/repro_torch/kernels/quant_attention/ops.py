"""Wrappers for kernels B1 and B2, the int4 flash-decode read over a
dense and over a paged cache (port of
``repro/kernels/quant_attention/ops.py:22`` and ``:63-109``).

``decode_attention_kernel`` folds ``folded_query_matrix()·scale`` into q,
flattens to ``(B·Hkv, G, d)`` rows, runs :func:`quant_decode_attention`
and applies ``rot_v.inverse`` to the one output vector.
``decode_attention_kernel_paged`` does the same over a paged int4 state:
the pools go in flattened to ``(n_pages·Hkv, page_size, ·)`` with the
page table, per-row ``plen = L - L mod W``, and
:func:`quant_decode_attention_paged` reads them.  On a CPU tensor each
runs its plain version (``ref.py``); on a CUDA tensor it launches
``csrc/quant_attention.cu`` (B1 or B2: the same split-K pass 1 with
another token address, and the same combine pass) or raises.  On a
``meta`` tensor it checks the arguments and returns outputs of the
kernel's shapes and dtypes, computing nothing.  On ``cuda`` and ``meta``
each call adds its analytic cost to an active cost census
(``launch/cost.py``).  ``launches`` and ``paged_launches`` count the
wrapper calls that launched B1 and B2, ``tc_launches`` those of either
whose pass 1 ran on the tensor cores (:func:`tensor_core_pass`, by shape
alone).  ``plan_rows`` sizes the split-K
plan for another row count than the call's own: a read split by head
over shards passes the unsplit read's ``B·Hkv``, so each row is reduced
in the same order and the shards' outputs equal the unsplit read's bit
for bit.  With ``return_lse=True`` B1 (and its plain version) also hands
back each (row, head)'s log-sum-exp of its scores, which a read split by
position over shards combines with (``launch/sharded_cache.py``);
``packed_len`` overrides ``decode_attention_kernel``'s ``L - L mod W``
for such a shard, whose packed segment need not end on a multiple of W.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import kvcache as kvc
from repro_torch.kernels import _build
from repro_torch.kernels.quant_attention.ref import (
    quant_decode_attention_paged_ref,
    quant_decode_attention_ref,
    row_lengths,
)
from repro_torch.launch import cost

__all__ = ["quant_decode_attention", "quant_decode_attention_paged",
           "decode_attention_kernel", "decode_attention_kernel_paged",
           "launches", "paged_launches", "tc_launches", "tensor_core_pass",
           "TILE", "MAX_G", "ARGTYPES"]

TILE = 64  # tokens per tile in csrc/quant_attention.cu (kTile)
MAX_G = 16  # query heads per KV head (kMaxG; above 8, two head groups)
launches = 0  # B1 launches since the caller last set this to 0
paged_launches = 0  # B2 launches since the caller last set this to 0
tc_launches = 0  # B1 or B2 launches whose pass 1 took the tensor cores
_FNS: dict = {}
_SMS: dict[int, int] = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C signatures of csrc/quant_attention.cu's launch functions
ARGTYPES = {
    "quant_decode_attention_launch":
        [_P] * 9 + [_I, _I] + [_P] * 4 + [_I] * 8 + [_P],
    "quant_decode_attention_paged_launch": [_P] * 13 + [_I] * 10 + [_P],
}


def _fn(name: str):
    """The bound launch function ``name`` of csrc/quant_attention.cu."""
    if name not in _FNS:
        lib = _build.library("quant_attention")
        fn = getattr(lib, name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = _I
        _FNS[name] = (lib, fn)
    return _FNS[name]


def tensor_core_pass(G: int, d: int, group: int) -> bool:
    """Whether B1/B2's pass 1 runs on the tensor cores
    (``qda_split_kernel_tc``) for G query heads a KV head at head dim d and
    scale group ``group``; the same rule as ``tensor_core_pass`` in
    csrc/quant_attention.cu.  Its fragments take 32-channel blocks, each in
    one scale group, and a row of at least two heads; one head (G = 1) or
    a d or group off a multiple of 32 (zamba2-7b's 112 / 28) keeps the
    first design's pass 1."""
    return G >= 2 and d % 32 == 0 and group % 32 == 0


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
META_SMS = 132  # an H100 SXM's SMs: the split plan of a meta call


def _lengths(x, rows, device):
    """int -> (scalar, None); tensor -> (0, per-row int32 (rows,) on device)."""
    if isinstance(x, int):
        return x, None
    return 0, row_lengths(x, rows, device).contiguous()


def _check(dev, expect: dict) -> None:
    for name, (t, dt, shape) in expect.items():
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need contiguous {dt} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _plan(q_eff, kr, n_tiles, group, plan_rows=None):
    """Checks shared by B1 and B2, then the split plan (for ``plan_rows``
    rows, default the call's) and the scratch: (part_ml, part_acc, out,
    n_splits, tiles_per_split)."""
    BH, G, d = q_eff.shape
    W, dev = kr.shape[1], q_eff.device
    if not 1 <= G <= MAX_G or d > 256 or d % 8 or d % group:
        raise ValueError(f"unsupported G={G} d={d} group={group}: B1/B2 "
                         f"take 1 to {MAX_G} query heads per KV head, d <= "
                         f"256, d % 8 == 0 and d % group == 0")
    if dev.type == "meta":
        sms = META_SMS
    else:
        idx = (dev.index if dev.index is not None
               else torch.cuda.current_device())
        if idx not in _SMS:
            _SMS[idx] = torch.cuda.get_device_properties(
                idx).multi_processor_count
        sms = _SMS[idx]
    max_splits = max(1, (_COMBINE_WORDS - 2 * W * d - G * W - 3 * G)
                     // (G * (d + 3)))
    n_splits, tps = split_plan(plan_rows or BH, n_tiles, sms, max_splits)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((BH, n_splits, G, 2), **f32),
            torch.empty((BH, n_splits, G, d), **f32),
            torch.empty((BH, G, d), **f32), n_splits, tps)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q_eff, kp, ks, vp, vs, kr, vr, packed_len, total_len, group,
            plan_rows=None, return_lse=False):
    global launches, tc_launches
    BH, G, d = q_eff.shape
    S, W = kp.shape[1], kr.shape[1]
    dev = q_eff.device
    _check(dev, {
        "q_eff": (q_eff, torch.float32, (BH, G, d)),
        "k_packed": (kp, torch.uint8, (BH, S, d // 2)),
        "v_packed": (vp, torch.uint8, (BH, S, d // 2)),
        "k_scales": (ks, torch.float32, (BH, S, d // group)),
        "v_scales": (vs, torch.float32, (BH, S, d // group)),
        "k_residual": (kr, torch.float32, (BH, W, d)),
        "v_residual": (vr, torch.float32, (BH, W, d)),
    })
    plen, plen_rows = _lengths(packed_len, BH, dev)
    tlen, tlen_rows = _lengths(total_len, BH, dev)
    # per-row lengths plan from S: B2 plans the same way, so a paged read
    # equals this one bitwise on the gathered view
    n_tiles = -(-(plen if plen_rows is None else S) // TILE)
    part_ml, part_acc, out, n_splits, tps = _plan(q_eff, kr, n_tiles, group,
                                                  plan_rows)
    lse = (torch.empty((BH, G), dtype=torch.float32, device=dev)
           if return_lse else None)
    if dev.type == "cuda":
        lib, fn = _fn("quant_decode_attention_launch")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(q_eff.data_ptr(), kp.data_ptr(), ks.data_ptr(),
                    vp.data_ptr(), vs.data_ptr(), kr.data_ptr(),
                    vr.data_ptr(), _ptr(plen_rows), _ptr(tlen_rows), plen,
                    tlen, part_ml.data_ptr(), part_acc.data_ptr(),
                    out.data_ptr(), _ptr(lse), BH, S, G, d, group, W,
                    n_splits, tps, stream)
        _build.check(lib, "quant_attention", rc)
        launches += 1
        tc_launches += tensor_core_pass(G, d, group)
    if cost.ACTIVE:  # per-row lengths are not read back: S tokens a row
        per_row = plen_rows is not None or tlen_rows is not None
        cost.record_kernel("quant_decode_attention", **cost.kernel_cost_b1(
            BH, G, d, group, W, BH * (S if plen_rows is not None else plen),
            per_row_lengths=per_row, lse=return_lse))
    return (out, lse) if return_lse else out


def _launch_paged(q_eff, kp, ks, vp, vs, kr, vr, packed_len, total_len,
                  page_table, group, page_size, H, plan_rows=None):
    global paged_launches, tc_launches
    ps = page_size
    BH, G, d = q_eff.shape
    B, MP = page_table.shape
    N, W = kp.shape[0], kr.shape[1]
    dev = q_eff.device
    if B * H != BH or N % H:
        raise ValueError(f"rows: B={B} * H={H} != BH={BH}, or pool rows "
                         f"{N} not a multiple of H")
    _check(dev, {
        "q_eff": (q_eff, torch.float32, (BH, G, d)),
        "k_packed": (kp, torch.uint8, (N, ps, d // 2)),
        "v_packed": (vp, torch.uint8, (N, ps, d // 2)),
        "k_scales": (ks, torch.float32, (N, ps, d // group)),
        "v_scales": (vs, torch.float32, (N, ps, d // group)),
        "k_residual": (kr, torch.float32, (BH, W, d)),
        "v_residual": (vr, torch.float32, (BH, W, d)),
        "page_table": (page_table, torch.int32, (B, MP)),
    })
    plen_rows = row_lengths(packed_len, BH, dev).contiguous()
    tlen_rows = row_lengths(total_len, BH, dev).contiguous()
    n_tiles = -(-(MP * ps) // TILE)  # B1's plan at S = MP * page_size
    part_ml, part_acc, out, n_splits, tps = _plan(q_eff, kr, n_tiles, group,
                                                  plan_rows)
    if dev.type == "cuda":
        lib, fn = _fn("quant_decode_attention_paged_launch")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(q_eff.data_ptr(), kp.data_ptr(), ks.data_ptr(),
                    vp.data_ptr(), vs.data_ptr(), kr.data_ptr(),
                    vr.data_ptr(), page_table.data_ptr(),
                    plen_rows.data_ptr(), tlen_rows.data_ptr(),
                    part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                    BH, H, MP, ps, G, d, group, W, n_splits, tps, stream)
        _build.check(lib, "quant_attention", rc)
        paged_launches += 1
        tc_launches += tensor_core_pass(G, d, group)
    if cost.ACTIVE:  # the lengths are not read back: every page a row maps
        cost.record_kernel("quant_decode_attention_paged",
                           **cost.kernel_cost_b2(BH, G, d, group, W,
                                                 BH * MP * ps, B * MP))
    return out


def quant_decode_attention(q_eff, k_packed, k_scales, v_packed, v_scales,
                           k_residual, v_residual, packed_len, total_len, *,
                           group: int = 32, blk: int = 256,
                           plan_rows: int | None = None,
                           return_lse: bool = False):
    """out_rot (BH, G, d) f32, and with ``return_lse`` its (BH, G) f32
    log-sum-exp; arguments as ``ref.quant_decode_attention_ref``.

    ``blk`` is the plain version's tile (the reference kernel's); the CUDA
    kernel tiles by :data:`TILE` tokens and splits the sequence itself."""
    if q_eff.device.type == "cpu":
        return quant_decode_attention_ref(
            q_eff, k_packed, k_scales, v_packed, v_scales, k_residual,
            v_residual, packed_len, total_len, group=group, blk=blk,
            return_lse=return_lse)
    if q_eff.device.type not in ("cuda", "meta"):
        raise ValueError(f"quant_decode_attention runs on cpu, cuda or meta, "
                         f"not {q_eff.device}")
    return _launch(q_eff, k_packed, k_scales, v_packed, v_scales, k_residual,
                   v_residual, packed_len, total_len, group, plan_rows,
                   return_lse)


def quant_decode_attention_paged(q_eff, k_packed, k_scales, v_packed,
                                 v_scales, k_residual, v_residual, packed_len,
                                 total_len, page_table, *, group: int = 32,
                                 page_size: int = 16, n_kv_heads: int = 1,
                                 plan_rows: int | None = None
                                 ) -> torch.Tensor:
    """out_rot (BH, G, d) f32 over flattened pools ``(n_pages*H, page_size,
    ·)``; arguments as ``ref.quant_decode_attention_paged_ref``."""
    if q_eff.device.type == "cpu":
        return quant_decode_attention_paged_ref(
            q_eff, k_packed, k_scales, v_packed, v_scales, k_residual,
            v_residual, packed_len, total_len, page_table, group=group,
            n_kv_heads=n_kv_heads)
    if q_eff.device.type not in ("cuda", "meta"):
        raise ValueError(f"quant_decode_attention_paged runs on cpu, cuda or "
                         f"meta, not {q_eff.device}")
    return _launch_paged(q_eff, k_packed, k_scales, v_packed, v_scales,
                         k_residual, v_residual, packed_len, total_len,
                         page_table, group, page_size, n_kv_heads,
                         plan_rows)


def _fold_query(q, rot_k, n_kv_heads, scale):
    B, Hq, _, d = q.shape
    sm = scale if scale is not None else d ** -0.5
    q_eff = (q.float() @ rot_k.folded_query_matrix().T) * sm
    return q_eff.reshape(B * n_kv_heads, Hq // n_kv_heads, d).contiguous()


def _per_kv_row(x, n_kv_heads):
    """A shared int passes through; per-row (B,) -> one entry per (b, h)
    (a broadcast, so a captured decode step reads no size back)."""
    if isinstance(x, int):
        return x
    return x[:, None].expand(-1, n_kv_heads).reshape(-1)


def decode_attention_kernel(q: torch.Tensor, cache, rot_k, rot_v, *,
                            scale: float | None = None, blk: int = 256,
                            plan_rows: int | None = None, packed_len=None,
                            return_lse: bool = False):
    """(B, Hq, 1, d) decode attention output in the original basis, and
    with ``return_lse`` the (B, Hq, 1) fp32 log-sum-exp of each query's
    scaled scores.  ``packed_len`` (default ``L - L mod W``) is where the
    residual window's first token sits."""
    B, Hq, _, d = q.shape
    Hkv = cache.k_packed.shape[1]
    q_eff = _fold_query(q, rot_k, Hkv, scale)
    if packed_len is None:
        packed_len = kvc.packed_len(cache)

    def flat(x):
        return x.reshape(B * Hkv, *x.shape[2:])

    got = quant_decode_attention(
        q_eff, flat(cache.k_packed), flat(cache.k_scales),
        flat(cache.v_packed), flat(cache.v_scales),
        flat(cache.k_residual), flat(cache.v_residual),
        _per_kv_row(packed_len, Hkv),
        _per_kv_row(cache.length, Hkv), group=cache.group, blk=blk,
        plan_rows=plan_rows, return_lse=return_lse,
    )
    out_rot, lse = got if return_lse else (got, None)
    out = rot_v.inverse(out_rot.reshape(B, Hq, 1, d)).to(q.dtype)
    return (out, lse.reshape(B, Hq, 1)) if return_lse else out


def decode_attention_kernel_paged(q: torch.Tensor, pd, rot_k, rot_v, *,
                                  scale: float | None = None,
                                  plan_rows: int | None = None
                                  ) -> torch.Tensor:
    """(B, Hq, 1, d) decode attention over a paged int4 state
    (``core.paged.PagedData``: pools ``(k_packed, k_scales, v_packed,
    v_scales)``, residual ``(k, v)`` windows), in the original basis.  The
    dense per-row view is never built."""
    B, Hq, _, d = q.shape
    N, Hkv, ps, _ = pd.pools[0].shape
    k_res, v_res = pd.residual
    group = d // pd.pools[1].shape[-1]
    L = pd.length
    plen = L - L % k_res.shape[-2]

    def flat(x):
        return x.reshape(-1, *x.shape[2:])

    out_rot = quant_decode_attention_paged(
        _fold_query(q, rot_k, Hkv, scale), *(flat(p) for p in pd.pools),
        flat(k_res), flat(v_res), _per_kv_row(plen, Hkv),
        _per_kv_row(L, Hkv), pd.page_table, group=group, page_size=ps,
        n_kv_heads=Hkv, plan_rows=plan_rows)
    return rot_v.inverse(out_rot.reshape(B, Hq, 1, d)).to(q.dtype)
