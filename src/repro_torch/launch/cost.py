"""The cost census: every ATen op a step runs, with its FLOPs,
transcendentals and bytes, plus one analytic record per launch of the
port's kernels.  It is the counterpart of XLA's ``cost_analysis()`` as the
reference reads it (``repro/launch/dryrun.py:156-166``,
``repro/launch/roofline_fit.py:80-98``), and of the HLO ``op_name``
metadata that ``repro/launch/hlo_probe.py:70-72`` prints.

    with CostCounter() as cc:
        step(params, token, cache)
    summarize(cc.records)  # {"flops", "bytes accessed", "transcendentals"}
    cost, records = cost_analysis(step, params, token, cache)

``CostCounter`` is a ``TorchDispatchMode``: it sees each op below
autograd, on ``meta`` tensors as on the card, so a step of a model built
on ``meta`` is costed with no memory and no card.  The conventions:

- FLOPs: the matmul class (mm, addmm, bmm, baddbmm, convolution, the
  fused attention ops) by ``torch.utils.flop_counter``'s formulas (2mnk);
  any other arithmetic op one FLOP per output element, and a reduction
  one per element it folds away (input minus output elements), as XLA's
  ``HloCostAnalysis`` counts them; so is a cast (``_to_copy`` or
  ``copy_`` to another dtype), XLA's elementwise ``convert``.  Other data
  movement (copies, gathers, scatters, concatenation, padding, fills,
  factories) counts none.
- transcendentals: exp, log, rsqrt, sqrt, tanh, sigmoid, erf, pow, sin,
  cos, ... one per output element, apart from the FLOPs, as XLA's
  ``transcendentals`` key is.
- bytes: each input tensor read once and each output written once, at its
  distinct elements (a broadcast dim counts once).  Views and metadata ops
  (view, reshape, expand, transpose, permute, slice, select,
  ``as_strided``, ``detach``, ``alias``) count nothing, nor does an
  allocation (``empty``).  A gather (``index``, ``embedding``, ...)
  reads the elements it returns and its indices; an in-place scatter
  (``index_put_``, ...) reads its values and indices and writes its
  values.  An in-place op reads its destination, unless it overwrites it
  whole (``copy_``, ``fill_``, ``zero_``).
- ``copy``: ``_to_copy`` and ``copy_`` record their source and
  destination device; ``roofline.collective_bytes`` sums those that
  cross devices.
- ``src``: the innermost stack frame inside ``repro_torch`` (this module
  aside), as ``path:line`` from the package's parent.
- a launch of one of the port's kernels is one record
  (:func:`record_kernel`, called by the wrappers on ``cuda`` and on
  ``meta``) with the analytic cost of :func:`kernel_cost_b1` ...
  :func:`kernel_cost_b4`, the bytes and FLOPs ``chip_smoke.py`` bounds
  each kernel with.  The ops a wrapper runs around its launch (its
  scratch allocations, a query fold) are recorded as ops.

Eager counting sees a layer loop once per layer: no loop body is counted
once, as XLA counts a while loop's body.  Under a captured CUDA graph the
ops (and the kernels' records) are seen at capture only.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpRecord", "CostCounter", "cost_analysis", "summarize", "costed",
           "record_kernel", "kernel_cost_b1", "kernel_cost_b2",
           "kernel_cost_b3", "kernel_cost_b4", "ACTIVE", "DATA_MOVEMENT"]

ACTIVE: list = []  # the CostCounters in effect, innermost last

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_HERE = os.path.abspath(__file__)

# metadata ops that the schema does not mark as views
_NO_BYTES = {"_unsafe_view", "lift_fresh", "_reshape_alias", "empty",
             "empty_strided", "empty_like", "new_empty", "new_empty_strided",
             "resize_", "set_", "sym_size", "sym_stride", "sym_numel"}
# data movement: no FLOPs (a cast aside)
DATA_MOVEMENT = {
    "_to_copy", "copy_", "clone", "cat", "stack", "constant_pad_nd",
    "repeat", "roll", "flip", "fill_", "zero_", "zeros", "ones", "full",
    "zeros_like", "ones_like", "full_like", "arange", "new_zeros",
    "new_ones", "new_full", "scalar_tensor", "lift_fresh_copy",
    "slice_scatter", "select_scatter", "_unsafe_index", "index",
    "index_select", "gather", "embedding", "take", "index_put_",
    "index_put", "_index_put_impl_", "scatter", "scatter_", "index_copy_",
    "index_copy", "eye", "normal_", "uniform_", "random_", "bernoulli_",
    "exponential_", "randperm", "_local_scalar_dense", "expand_copy",
    "unfold_copy"}
_GATHERS = {"index", "_unsafe_index", "index_select", "gather", "embedding",
            "take"}
_SCATTERS = {"index_put_", "_index_put_impl_", "scatter_", "index_copy_"}
_OVERWRITES = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
               "bernoulli_", "exponential_"}
_COPIES = {"_to_copy", "copy_"}
_TRANSCENDENTAL = {"exp", "exp_", "exp2", "expm1", "log", "log_", "log1p",
                   "log2", "log10", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "tanh",
                   "tanh_", "sigmoid", "sigmoid_", "erf", "erf_", "erfc",
                   "erfinv", "sin", "cos", "tan", "pow", "pow_", "atan2",
                   "logit"}
# fused ops: (FLOPs, transcendentals) per output element
_FUSED = {"silu": (1, 1), "silu_": (1, 1), "gelu": (4, 1), "softplus": (2, 2),
          "_softmax": (3, 1), "_log_softmax": (3, 2), "logsumexp": (3, 2)}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
               "argmin", "any", "all", "var", "std", "var_mean", "norm",
               "linalg_vector_norm", "logsumexp", "count_nonzero"}


@dataclasses.dataclass
class OpRecord:
    """One op (or one kernel launch) of a census."""

    op: str  # "aten.mm", or a kernel's name
    dtype: str
    flops: float
    transcendentals: float
    bytes_read: int
    bytes_written: int
    src: str = ""  # the innermost frame inside repro_torch, path:line
    copy: Optional[tuple] = None  # (source device, destination device)
    kernel: bool = False

    @property
    def nbytes(self) -> int:
        return self.bytes_read + self.bytes_written

    def key(self) -> tuple:
        """What two censuses of one step must agree on, device aside."""
        return (self.op, self.dtype, self.flops, self.transcendentals,
                self.bytes_read, self.bytes_written, self.src, self.kernel)


def _nbytes(t: torch.Tensor) -> int:
    """Distinct bytes a tensor addresses: a dim of stride 0 counts once."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


_REL: dict = {}  # file -> its path from the package's parent, or None


def _src() -> str:
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        rel = _REL.get(name, 0)
        if rel == 0:  # a path through "..", as a sys.path entry may hold
            full = os.path.abspath(name)
            rel = _REL[name] = (os.path.relpath(full, _ROOT)
                                if full.startswith(_PKG + os.sep)
                                and full != _HERE else None)
        if rel is not None:
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return ""


def _tensors(args, kwargs) -> list:
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out += [t for t in a if isinstance(t, torch.Tensor)]
    return out


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _record(func, args, kwargs, out) -> OpRecord:
    from torch.utils.flop_counter import flop_registry

    name = func.overloadpacket.__name__
    op = f"aten.{name}"
    schema = func._schema.arguments
    written = {id(v) for a, v in zip(schema, args)
               if a.alias_info is not None and a.alias_info.is_write}
    written |= {id(v) for k, v in kwargs.items()
                if isinstance(v, torch.Tensor) and any(
                    a.name == k and a.alias_info is not None
                    and a.alias_info.is_write for a in schema)}
    ins = _tensors(args, kwargs)
    outs = ([t for t in ins if id(t) in written] if written
            else _tensors(out if isinstance(out, (list, tuple)) else (out,),
                          {}))
    dtype = _dtype(ins[0] if ins else outs[0]) if ins or outs else ""
    if func.is_view or name in _NO_BYTES:
        return OpRecord(op, dtype, 0.0, 0.0, 0, 0)
    reads = [t for t in ins if id(t) not in written]
    if name.endswith("_") and name not in _OVERWRITES:
        reads += [t for t in ins if id(t) in written]
    n_out = sum(t.numel() for t in outs)
    rd = sum(_nbytes(t) for t in reads)
    wr = sum(_nbytes(t) for t in outs)
    if name in _GATHERS:
        rd = wr + sum(_nbytes(t) for t in ins[1:])
    elif name in _SCATTERS:
        vals = [t for t in reads if id(t) not in written]
        dst = outs[0]
        wr = sum(t.numel() for t in vals[-1:]) * dst.element_size()
        rd = sum(_nbytes(t) for t in vals)
    flops = transc = 0.0
    packet = func.overloadpacket
    src_t = (ins[0] if name == "_to_copy" else ins[1]) \
        if name in _COPIES else None
    if packet in flop_registry:
        flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
    elif src_t is not None:  # a cast is XLA's elementwise convert
        flops = float(n_out) if src_t.dtype != outs[0].dtype else 0.0
    elif name in DATA_MOVEMENT:
        pass
    elif name in _FUSED:
        f, t = _FUSED[name]
        flops, transc = float(f * n_out), float(t * n_out)
    elif name in _TRANSCENDENTAL and not (
            name.startswith("pow") and not isinstance(args[1], torch.Tensor)):
        transc = float(n_out)  # x ** 2 is a multiply, as XLA's integer_pow
    elif name in _REDUCTIONS and ins:
        flops = float(max(ins[0].numel() - n_out, 0))
    else:
        flops = float(n_out)
    copy = None if src_t is None else (str(src_t.device),
                                       str(outs[0].device))
    return OpRecord(op, dtype, flops, transc, rd, wr, copy=copy)


class CostCounter(TorchDispatchMode):
    """Records every op run inside the block (``records``), and every
    kernel launch the wrappers report (:func:`record_kernel`)."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []

    def __enter__(self):
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rec = _record(func, args, kwargs, out)
        rec.src = _src()
        self.records.append(rec)
        return out


def record_kernel(name: str, flops: float, bytes_read: int,
                  bytes_written: int, dtype: str = "float32") -> None:
    """One record of a kernel launch in every active counter; with none
    active, one check of a module-level list."""
    if not ACTIVE:
        return
    src = _src()
    for cc in ACTIVE:
        cc.records.append(OpRecord(name, dtype, float(flops), 0.0,
                                   int(bytes_read), int(bytes_written), src,
                                   kernel=True))


def costed(records) -> list:
    """The records that move a byte or do an operation, kernels included:
    what two censuses of one step on two devices must agree on, op for
    op.  Ops that cost nothing may differ by device: ``torch.tensor(...,
    device=)`` dispatches ``lift_fresh`` on cpu and cuda, nothing on
    meta."""
    return [r for r in records
            if r.kernel or r.nbytes or r.flops or r.transcendentals]


def summarize(records) -> dict:
    """The reference's ``cost_analysis`` keys over a census."""
    return {"flops": float(sum(r.flops for r in records)),
            "bytes accessed": float(sum(r.nbytes for r in records)),
            "transcendentals": float(sum(r.transcendentals
                                         for r in records))}


def cost_analysis(fn, *args, **kwargs) -> tuple[dict, list]:
    """(the reference's keys, the records) of one call of ``fn``."""
    with CostCounter() as cc:
        fn(*args, **kwargs)
    return summarize(cc.records), cc.records


# ------------------------------------------------------------------ kernels
# The analytic cost of one launch: each input read once, each output
# written once (the bytes the function must move), and its FLOPs.  The
# product FLOPs run on fp32 operands (CUDA cores).

def _cost(flops, bytes_read, bytes_written) -> dict:
    return {"flops": float(flops), "bytes_read": int(bytes_read),
            "bytes_written": int(bytes_written)}


def kernel_cost_b1(BH: int, G: int, d: int, group: int, W: int,
                   packed_tokens: int, *, per_row_lengths: bool = False,
                   lse: bool = False) -> dict:
    """B1, the int4 flash-decode read: the folded query (BH, G, d) fp32,
    K and V codes and scales of ``packed_tokens`` packed tokens over all
    rows (BH x plen at a shared length), both fp32 W-token rings, the
    per-row lengths if given; writes (BH, G, d) fp32 and the lse (BH, G).
    FLOPs: a multiply-add for q.k and one for p.v per (head, token)."""
    reads = (BH * G * d * 4 + 2 * packed_tokens * (d // 2 + d // group * 4)
             + 2 * BH * W * d * 4 + (2 * BH * 4 if per_row_lengths else 0))
    writes = BH * G * d * 4 + (BH * G * 4 if lse else 0)
    return _cost(4.0 * G * d * (packed_tokens + BH * W), reads, writes)


def kernel_cost_b2(BH: int, G: int, d: int, group: int, W: int,
                   packed_tokens: int, table_entries: int) -> dict:
    """B2, B1's read through a page table: B1's bytes with per-row
    lengths, plus the (B, max_pages) int32 table."""
    c = kernel_cost_b1(BH, G, d, group, W, packed_tokens,
                       per_row_lengths=True)
    c["bytes_read"] += table_entries * 4
    return c


def kernel_cost_b3(n: int, d: int, group: int, *, x_itemsize: int,
                   matrix: bool, lam: bool, bits: int = 4) -> dict:
    """B3, rotate + quantize + pack: x (n, d), the (d, d) fp32 matrix and
    the (d,) lambda if given; writes the codes (n, d·bits/8) and the fp32
    scales (n, d/group).  FLOPs: the product, 2·n·d², if a matrix."""
    reads = n * d * x_itemsize + (d * d * 4 if matrix else 0) \
        + (d * 4 if lam else 0)
    writes = n * d * bits // 8 + n * (d // group) * 4
    return _cost(2.0 * n * d * d if matrix else 0.0, reads, writes)


def kernel_cost_b4(n: int, d: int, group: int, *, bits: int = 4) -> dict:
    """B4, unpack + dequantize + inverse rotation: codes (n, d·bits/8),
    fp32 scales (n, d/group) and the (d, d) fp32 matrix; writes (n, d)
    fp32.  FLOPs: the product, 2·n·d²."""
    reads = n * d * bits // 8 + n * (d // group) * 4 + d * d * 4
    return _cost(2.0 * n * d * d, reads, n * d * 4)

