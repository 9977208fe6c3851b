"""The benchmark's own FLOP and byte counts held to the port's census
(``repro_torch.launch.cost``) at a reduced size."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tinycell  # noqa: E402

import json  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from perfbench import costs, harness  # noqa: E402
from repro_torch.launch import cost  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

MATMUL = {"aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm"}


def _cfg(**kw):
    cj = json.loads((tinycell.ROOT / "perfbench/configs/qwen3-14b.json")
                    .read_text())
    cj.update(tinycell.TINY)
    cj.update(kw)
    return harness.model_config(cj)


def _weight_flops(records):
    """The census's matmul FLOPs of the model's weights (``dense`` in
    models/common.py, which every projection and the unembedding use)."""
    return sum(r.flops for r in records
               if r.op in MATMUL and r.src.startswith(
                   "repro_torch/models/common.py"))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_weight_and_unembedding_flops_match_the_census(qk_norm):
    cfg = _cfg(qk_norm=qk_norm)
    params, signs = harness.make_weights(cfg, 3, "cpu")
    model = LM(cfg, device="cpu")
    n = 48
    cache = model.init_cache(1, 128, policy="int4-srft")
    toks = torch.randint(0, cfg.vocab_size, (1, n))
    with cost.CostCounter() as cc:
        _, cache = model.prefill(params, toks, cache)
    want = n * costs.weight_flops_per_token(cfg) + costs.unembed_flops(cfg)
    assert _weight_flops(cc.records) == pytest.approx(want)
    with cost.CostCounter() as cc:
        model.decode_step(params, toks[:, :1], cache, backend="gather")
    assert _weight_flops(cc.records) == pytest.approx(
        costs.weight_flops_per_token(cfg) + costs.unembed_flops(cfg))


def test_prefill_attention_flops_are_the_causal_share_of_the_census():
    """flash.py computes every (query, key) block; the count keeps the
    causal half plus the diagonal: census x (n + 1) / (2 n) at a length
    that fills its blocks."""
    cfg = _cfg()
    params, _ = harness.make_weights(cfg, 3, "cpu")
    model = LM(cfg, device="cpu")
    n = 64
    cache = model.init_cache(1, 128, policy="int4-srft")
    toks = torch.randint(0, cfg.vocab_size, (1, n))
    with cost.CostCounter() as cc:
        model.prefill(params, toks, cache, kv_block=n)
    flash = sum(r.flops for r in cc.records
                if r.src.startswith("repro_torch/models/flash.py")
                and r.op in MATMUL)
    attn = costs.prefill_flops(cfg, n) - n * costs.weight_flops_per_token(
        cfg) - costs.unembed_flops(cfg)
    assert attn == pytest.approx(flash * (n + 1) / (2 * n))


@pytest.mark.parametrize("lengths", [[64, 128], [16, 48, 96, 32]])
def test_b2_work_is_the_census_record_at_the_rows_lengths(lengths):
    """At lengths on a flush boundary that fill their pages, B2's needed
    bytes and FLOPs are the census's ``kernel_cost_b2`` less the W-token
    rings it counts whole (the window holds nothing live there)."""
    cfg = _cfg()
    hkv, hd, W = cfg.n_kv_heads, cfg.head_dim, 16
    g = cfg.n_heads // hkv
    BH = len(lengths) * hkv
    pages = [L // 16 for L in lengths]
    c = cost.kernel_cost_b2(BH, g, hd, 32, W, hkv * sum(lengths), sum(pages))
    flops, nbytes = costs.b2_step_work(cfg, lengths)
    ring_bytes = 2 * BH * W * hd * 4
    lens_bytes = 2 * BH * 4
    assert nbytes == c["bytes_read"] + c["bytes_written"] - ring_bytes \
        - lens_bytes
    assert flops == pytest.approx(c["flops"] - 4.0 * g * hd * BH * W)


def test_decode_flops_grow_with_the_rows_length():
    cfg = _cfg()
    a, b = costs.decode_token_flops(cfg, 100), costs.decode_token_flops(
        cfg, 101)
    assert b - a == pytest.approx(4.0 * cfg.n_layers * cfg.n_heads
                                  * cfg.head_dim)
