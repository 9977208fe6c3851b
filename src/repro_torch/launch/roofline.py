"""Analytic roofline terms, the collective bytes, the bound of an eager
step and the model-FLOPs yardstick (port of ``repro/launch/roofline.py``:
``parse_collective_bytes``, ``roofline_terms``, ``count_params``,
``model_flops_estimate``) on the H100's data-sheet rates
(``launch/mesh.HW``).

Three terms, in seconds:

    compute    = FLOPs / DATASHEET_BF16_FLOP_PER_S
    memory     = bytes / DATASHEET_HBM_BYTES_PER_S
    collective = collective_bytes / DATASHEET_NVLINK_BYTES_PER_S

The reference reads the FLOPs and bytes from XLA's compiled module
(``cost_analysis``) and the collective bytes from its optimized HLO text.
The port reads them from the cost census of the step (``launch/cost.py``):
``collective_bytes`` sums its cross-device copies, and ``step_bound`` is
the least time the census's ops take one by one.  These are data-sheet
bounds, not measurements.
"""
from __future__ import annotations

import numpy as np

from repro_torch.launch import partitioning as pt
from repro_torch.launch.mesh import HW

__all__ = ["collective_bytes", "step_bound", "op_bound_s", "roofline_terms",
           "count_params", "model_flops_estimate", "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(records) -> dict:
    """The reference's ``parse_collective_bytes`` dict (bytes and counts
    per kind, and ``total``) over a cost census.

    The port's mesh is single-controller: a sharded step moves data by
    copies between devices (``_to_copy`` / ``copy_`` whose source and
    destination differ), not by named collectives.  So the five XLA kinds
    stay 0, and those copies' output bytes are summed under one more kind,
    ``device-copy``, which ``total`` includes."""
    kinds = COLLECTIVES + ("device-copy",)
    out = dict.fromkeys(kinds, 0)
    counts = dict.fromkeys(kinds, 0)
    for r in records:
        if r.copy is not None and r.copy[0] != r.copy[1]:
            out["device-copy"] += r.bytes_written
            counts["device-copy"] += 1
    out["total"] = sum(out[k] for k in kinds)
    out["counts"] = counts
    return out


def op_bound_s(rec) -> float:
    """The least time one census record takes: the larger of its bytes
    over HBM and its FLOPs over the peak for its dtype (the tensor cores'
    for bf16 / fp16; the CUDA cores' for the rest, since the port runs
    with TF32 off)."""
    peak = (HW.DATASHEET_BF16_FLOP_PER_S
            if rec.dtype in ("bfloat16", "float16")
            else HW.DATASHEET_FP32_FLOP_PER_S)
    return max(rec.nbytes / HW.DATASHEET_HBM_BYTES_PER_S, rec.flops / peak)


def step_bound(records) -> float:
    """Seconds: the bound of an eager step, op by op -- the sum of
    :func:`op_bound_s` over its census, every op's bytes through HBM once
    as eager execution moves them (no fusion)."""
    return sum(op_bound_s(r) for r in records)


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    compute = flops_per_dev / HW.DATASHEET_BF16_FLOP_PER_S
    memory = bytes_per_dev / HW.DATASHEET_HBM_BYTES_PER_S
    collective = coll_bytes_per_dev / HW.DATASHEET_NVLINK_BYTES_PER_S
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k])
    return terms


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the "useful compute" yardstick)
# ---------------------------------------------------------------------------

def count_params(params, *, moe_scale: float = 1.0) -> tuple:
    """(total, active) parameter counts of a params tree (tensors, on any
    device, ``meta`` included, or ``ShapeLeaf``s).  Expert leaves (a
    ``w_gate`` / ``w_up`` / ``w_down`` under a path naming ``moe``) count
    toward ``active`` scaled by top_k / n_experts, as the reference's rule
    reads its stacked tree; the port's per-layer lists only add list
    indices to the paths."""
    total = active = 0
    for path, leaf in pt.flatten_with_path(params):
        n = int(np.prod(leaf.shape))
        total += n
        names = [str(p) for p in path]
        if any("w_gate" in s or "w_up" in s or "w_down" in s
               for s in names) and any("moe" in s for s in names):
            active += int(n * moe_scale)
        else:
            active += n
    return total, active


def model_flops_estimate(cfg, shape, params) -> dict:
    """MODEL_FLOPS: 6*N*D train (dense), 6*N_active*D MoE; forward-only
    (2*N*D) for serving cells, plus the attention term."""
    moe_scale = (cfg.moe.top_k / cfg.moe.n_experts if cfg.moe is not None
                 else 1.0)
    n_total, n_active = count_params(params, moe_scale=moe_scale)
    B, S = shape.global_batch, shape.seq_len
    n_attn = (
        cfg.n_layers if cfg.family in ("dense", "moe", "vlm")
        else (cfg.n_layers // cfg.shared_attn_period if cfg.family == "hybrid"
              else 0)
    )
    if cfg.family == "audio":
        n_attn = cfg.n_layers + cfg.encoder_layers
    hq_hd = cfg.n_heads * cfg.head_dim
    if shape.kind == "train":
        D = B * S
        flops = 6.0 * n_active * D
        # causal ~x0.5, fwd+bwd x3: net 3x
        flops += 3 * 2.0 * B * S * S * hq_hd * n_attn
    elif shape.kind == "prefill":
        D = B * S
        flops = 2.0 * n_active * D
        flops += 2.0 * B * S * S * hq_hd * n_attn * 0.5 * 2  # qk + pv, causal
    else:  # decode: one token, full-context attention reads
        D = B
        flops = 2.0 * n_active * D
        flops += 4.0 * B * S * hq_hd * n_attn
    return {"params_total": n_total, "params_active": n_active,
            "model_flops": flops}
