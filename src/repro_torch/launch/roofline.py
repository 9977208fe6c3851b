"""Analytic roofline terms and the model-FLOPs yardstick (port of
``repro/launch/roofline.py``: ``roofline_terms``, ``count_params``,
``model_flops_estimate``) on the H100's data-sheet rates
(``launch/mesh.HW``).

Three terms, in seconds, per device:

    compute    = FLOPs_per_device / DATASHEET_BF16_FLOP_PER_S
    memory     = bytes_per_device / DATASHEET_HBM_BYTES_PER_S
    collective = collective_bytes_per_device / DATASHEET_NVLINK_BYTES_PER_S

The reference reads the FLOPs and bytes from XLA's compiled module
(``cost_analysis``) and the collective bytes from its optimized HLO text
(``parse_collective_bytes``).  The port compiles no whole-program module,
so those inputs have no counterpart here: the caller supplies the counts
(``launch/dryrun.py`` records the per-device argument bytes and
``model_flops_estimate``; measured times come from ``chip_smoke.py``'s
profiler attribution).  These are data-sheet bounds, not measurements.
"""
from __future__ import annotations

import numpy as np

from repro_torch.launch import partitioning as pt
from repro_torch.launch.mesh import HW

__all__ = ["roofline_terms", "count_params", "model_flops_estimate"]


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
