"""The cost census (``launch/cost.py``): its conventions on hand-sized ops,
a ``meta`` census equal to a CPU census op for op, its FLOPs against the
reference's XLA ``cost_analysis()``, the kernel wrappers' ``meta``
branch and their records, and the kernels' analytic costs.

The reference's count runs in a subprocess: an unrolled reference sets
``REPRO_UNROLL_SCANS`` before ``repro.models`` is imported, which would
change every later test in this process.  The census and XLA do not
count alike, so the comparison holds each cell's measured ratio within a
stated tolerance and names the terms of the gap (see
``test_census_flops_against_xla``)."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.quant_attention import ops as qa_ops  # noqa: E402
from repro_torch.kernels.srft_quant import ops as sq_ops  # noqa: E402
from repro_torch.launch import cost, roofline  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adam import adam_init  # noqa: E402

torch.set_num_threads(1)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the XLA cells: reduced internlm2 at 2 layers, batch 2, 64 tokens, s_max 128
N_LAYERS, B, S, S_MAX = 2, 2, 64, 128


def _cfg(n_layers=N_LAYERS):
    return dataclasses.replace(reduced(get_config("internlm2-1.8b")),
                               n_layers=n_layers)


def _one(records, op):
    (r,) = [r for r in records if r.op == op]
    return r


def test_census_of_hand_sized_ops():
    a = torch.randn(4, 8)
    b = torch.randn(8, 3)
    with cost.CostCounter() as cc:
        c = a @ b
        d = c + 1
        e = c.view(12)
        f = c.exp()
        s = c.sum(-1)
        w = torch.ones(4, 1).expand(4, 8) + a
        a.add_(1)
        a.copy_(w)
        m = a.to("meta")
        same = a.to("cpu")
        wide = c.to(torch.float64)
    rec = cc.records
    mm = _one(rec, "aten.mm")
    assert (mm.flops, mm.bytes_read, mm.bytes_written) == (
        2 * 4 * 8 * 3, (32 + 24) * 4, 12 * 4)
    add = [r for r in rec if r.op == "aten.add"]
    assert (add[0].flops, add[0].bytes_read, add[0].bytes_written) == (
        12, 48, 48)
    # a broadcast operand is read at its distinct elements
    assert (add[1].bytes_read, add[1].bytes_written) == (4 * 4 + 32 * 4,
                                                        32 * 4)
    view = _one(rec, "aten.view")
    assert (view.flops, view.nbytes) == (0, 0)
    ex = _one(rec, "aten.exp")
    assert (ex.flops, ex.transcendentals) == (0, 12)
    assert _one(rec, "aten.sum").flops == 12 - 4  # folded elements
    inplace = _one(rec, "aten.add_")
    assert (inplace.bytes_read, inplace.bytes_written) == (32 * 4, 32 * 4)
    cp = [r for r in rec if r.op == "aten.copy_"]
    assert (cp[0].bytes_read, cp[0].bytes_written, cp[0].flops) == (
        32 * 4, 32 * 4, 0)
    casts = [r for r in rec if r.op == "aten._to_copy"]
    assert [r.copy for r in casts] == [("cpu", "meta"), ("cpu", "cpu")]
    assert casts[1].flops == 12  # a cast is XLA's elementwise convert
    assert same is a  # a same-device .to dispatches nothing
    coll = roofline.collective_bytes(rec)
    assert coll["device-copy"] == coll["total"] == 32 * 4
    assert coll["counts"]["device-copy"] == 1
    assert all(coll[k] == 0 for k in roofline.COLLECTIVES)
    summary = cost.summarize(rec)
    assert set(summary) == {"flops", "bytes accessed", "transcendentals"}
    assert summary["flops"] == sum(r.flops for r in rec)
    assert summary["bytes accessed"] == sum(r.nbytes for r in rec)
    del d, e, f, s, m, wide
    # the kernel hook: nothing without a counter, one record with one
    cost.record_kernel("k", 1.0, 2, 3)
    with cost.CostCounter() as cc:
        cost.record_kernel("k", 1.0, 2, 3)
    assert [(r.op, r.kernel, r.nbytes) for r in cc.records] == [("k", True,
                                                                 5)]
    assert cost.ACTIVE == []


def _serve_census(device, backend, policy="bf16", prompt_len=45, steps=3):
    """Census of a prefill and ``steps`` decode steps of the reduced
    model on ``device``: a list of record lists, one per call."""
    cfg = _cfg()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(B, S_MAX, policy=policy,
                             generator=torch.Generator().manual_seed(0))
    tokens = torch.zeros((B, prompt_len), dtype=torch.int64, device=device)
    step = make_decode_step(model, backend=backend)
    out = []
    with torch.no_grad():
        with cost.CostCounter() as cc:
            lg, cache = model.prefill(params, tokens, cache)
        out.append(cc.records)
        tok = lg[:, -1:].argmax(-1)
        for _ in range(steps):
            with cost.CostCounter() as cc:
                lg, cache = step(params, tok, cache)
            out.append(cc.records)
            tok = lg[:, -1:].argmax(-1)
    return out


@pytest.mark.parametrize("backend", [None, "blockwise"])
def test_meta_census_equals_cpu_census(backend):
    """A bf16 prefill and decode steps of the reduced model: the census
    on meta equals the CPU census op for op over the ops that cost
    something (``cost.costed``)."""
    got = _serve_census("meta", backend)
    want = _serve_census("cpu", backend)
    for g, w in zip(got, want):
        gk = [r.key() for r in cost.costed(g)]
        assert gk == [r.key() for r in cost.costed(w)]
        assert len(gk) > 100


_XLA_SCRIPT = r"""
import dataclasses, json
import jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.launch.steps import (make_decode_step, make_prefill_step,
                                make_train_step)
from repro.models import build_model
from repro.optim.adam import adam_init, adam_update, clip_by_global_norm
N, B, S, S_MAX = {args}
cfg = dataclasses.replace(reduced(get_config("internlm2-1.8b")), n_layers=N)
model = build_model(cfg)
params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
cache = jax.eval_shape(lambda: model.init_cache(B, S_MAX, policy="bf16"))
batch = {{"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}}
opt = jax.eval_shape(adam_init, params)


def flops(fn, *args):
    low = jax.jit(fn).lower(*args)
    c = low.compile().cost_analysis()
    c = c[0] if isinstance(c, list) else c
    return {{"compiled": float(c["flops"]),
             "lowered": float(low.cost_analysis()["flops"])}}


def train_no_remat(params, opt_state, batch):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: model.loss(p, batch, remat=False), has_aux=True)(params)
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    params, opt_state = adam_update(grads, opt_state, params, lr=3e-4)
    return params, opt_state, {{"loss": loss, "grad_norm": gnorm, **metrics}}


print(json.dumps({{
    "prefill": flops(make_prefill_step(model), params, batch, cache),
    "decode": flops(make_decode_step(model),  params,
                    jax.ShapeDtypeStruct((B, 1), jnp.int32), cache),
    "train": flops(make_train_step(model), params, opt, batch),
    "train_no_remat": flops(train_no_remat, params, opt, batch),
}}))
"""


@pytest.fixture(scope="module")
def xla_flops():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_UNROLL_SCANS="1", REPRO_BF16_DOTS="0")
    script = _XLA_SCRIPT.format(args=(N_LAYERS, B, S, S_MAX))
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _port_flops() -> dict:
    """The census's FLOPs of the same cells, on meta."""
    model = build_model(_cfg(), device="meta")
    params = model.init(torch.Generator())
    cache = model.init_cache(B, S_MAX, policy="bf16")
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32,
                                   device="meta")}
    out = {}
    out["prefill"], _ = cost.cost_analysis(make_prefill_step(model), params,
                                           batch, cache)
    out["decode"], _ = cost.cost_analysis(make_decode_step(model), params,
                                          batch["tokens"][:, :1], cache)
    out["train"], _ = cost.cost_analysis(make_train_step(model), params,
                                         adam_init(params), batch)
    return {k: v["flops"] for k, v in out.items()}


# census / XLA's compiled count of the reference's step, as measured, and
# the tolerance it is held to.  The terms of the gap: the reference's
# train step recomputes each block's forward in its backward
# (jax.checkpoint), which the port's autograd does not; XLA's fusion
# pass counts the fp32 casts of the bf16 weights once per fused consumer
# (the decode step's weights are cast in fp32-operand mode); the rest is
# under 1%.  Before fusion (``lowered``) XLA counts the same ops as the
# census: held within 1%, the train step against the reference's step
# without remat.
XLA_RATIO = {"prefill": 0.977, "decode": 0.595, "train": 0.768}
XLA_RATIO_TOL = 0.02
LOWERED_RTOL = 0.01


def test_census_flops_against_xla(xla_flops):
    port = _port_flops()
    for cell, ratio in XLA_RATIO.items():
        got = port[cell] / xla_flops[cell]["compiled"]
        assert abs(got - ratio) <= XLA_RATIO_TOL, (cell, got)
        ref = xla_flops["train_no_remat" if cell == "train" else cell]
        assert abs(port[cell] / ref["lowered"] - 1) <= LOWERED_RTOL, (
            cell, port[cell], ref)


def test_int4_census_on_meta_counts_each_kernel_launch():
    """The paper's policy on meta: B3 twice a layer at the prefill's bulk
    write and at each W-flush, B1 once a layer a decode step, each record
    carrying its analytic cost."""
    cfg = _cfg()
    W = 16
    prompt = 45
    calls = _serve_census("meta", "kernel", policy="int4-srft",
                          prompt_len=prompt, steps=W)
    d, Hkv = cfg.head_dim, cfg.n_kv_heads
    G = cfg.n_heads // Hkv

    def kernels(records, name):
        return [r for r in records if r.kernel and r.op == name]

    assert len(kernels(calls[0], "srft_quant")) == 2 * cfg.n_layers
    for i, records in enumerate(calls[1:]):
        L = prompt + i  # the length before this step
        b1 = kernels(records, "quant_decode_attention")
        assert len(b1) == cfg.n_layers
        plen = (L + 1) - (L + 1) % W
        want = cost.kernel_cost_b1(B * Hkv, G, d, 32, W, B * Hkv * plen)
        assert (b1[0].flops, b1[0].bytes_read, b1[0].bytes_written) == (
            want["flops"], want["bytes_read"], want["bytes_written"])
        flush = L % W == W - 1
        assert len(kernels(records, "srft_quant")) == (
            2 * cfg.n_layers if flush else 0), (i, L)


def _b1_args(device, BH=6, G=3, S=96, d=64, group=32, W=16):
    g = torch.Generator().manual_seed(1)
    q = torch.randn((BH, G, d), generator=g)
    kp = torch.randint(0, 256, (BH, S, d // 2), generator=g,
                       dtype=torch.uint8)
    ks = torch.rand((BH, S, d // group), generator=g)
    kr = torch.randn((BH, W, d), generator=g)
    return tuple(t.to(device) for t in (q, kp, ks, kp, ks, kr, kr))


def _meta_equals_cpu(fn, *args, **kw):
    got = fn(*(a.to("meta") if isinstance(a, torch.Tensor) else a
               for a in args), **kw)
    want = fn(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(t.shape, t.dtype, t.device.type) for t in got] == [
        (t.shape, t.dtype, "meta") for t in want]


def test_wrappers_meta_outputs_equal_the_plain_versions_shapes():
    before = (qa_ops.launches, qa_ops.paged_launches, sq_ops.launches,
              sq_ops.dequant_launches)
    args = _b1_args("cpu")
    for kw in ({}, {"return_lse": True}):
        _meta_equals_cpu(qa_ops.quant_decode_attention, *args, 80, 87,
                         group=32, **kw)
        rows = torch.tensor([0, 16, 48, 64, 80, 80], dtype=torch.int32)
        _meta_equals_cpu(qa_ops.quant_decode_attention, *args, rows,
                         rows + 3, group=32, **kw)
    # B2 over pools of 4-token pages, two rows of 3 KV heads
    q, kp, ks, _, _, kr, _ = args
    pools = (kp[:, :8].reshape(-1, 4, 32), ks[:, :8].reshape(-1, 4, 2))
    table = torch.tensor([[0, 1, 2], [3, 2, 1]], dtype=torch.int32)
    lens = torch.tensor([9, 11, 9, 11, 9, 11], dtype=torch.int32)
    _meta_equals_cpu(qa_ops.quant_decode_attention_paged, q, *pools, *pools,
                     kr, kr, lens - lens % 16, lens, table, group=32,
                     page_size=4, n_kv_heads=3)
    x = torch.randn(40, 64)
    m = torch.linalg.qr(torch.randn(64, 64))[0].contiguous()
    for bits in (4, 8):
        for mat, lam in ((m, torch.ones(64)), (None, None)):
            _meta_equals_cpu(sq_ops.srft_quant, x, mat, lam, group=32,
                             bits=bits)
            _meta_equals_cpu(sq_ops.srft_quant, x.bfloat16(), mat, lam,
                             group=32, bits=bits)
        pk, sc = sq_ops.srft_quant(x, m, group=32, bits=bits)
        _meta_equals_cpu(sq_ops.srft_dequant, pk, sc, m.T.contiguous(),
                         group=32, bits=bits)
    assert before == (qa_ops.launches, qa_ops.paged_launches,
                      sq_ops.launches, sq_ops.dequant_launches)
    with pytest.raises(ValueError):  # the wrappers' checks hold on meta
        qa_ops.quant_decode_attention(args[0].to("meta").double(),
                                      *(a.to("meta") for a in args[1:]), 80,
                                      87, group=32)


# (BH, G, d, group, S) -> (n_splits, tiles_per_split) on an H100's 132
# SMs: the split plan is the same whichever pass 1 the shape takes
@pytest.mark.parametrize("shape,plan", [
    ((512, 2, 128, 32, 16384), (2, 128)),   # internlm2-1.8b's long cell
    ((256, 5, 128, 32, 16384), (3, 86)),    # qwen3-14b's long cell
    ((8, 2, 128, 32, 4608), (36, 2)),       # internlm2-1.8b at batch 1
    ((16, 1, 256, 32, 4096), (32, 2)),      # gemma-7b (first pass 1)
    ((32, 16, 128, 32, 2048), (16, 2)),     # two head groups
    ((4, 2, 112, 28, 2064), (33, 1)),       # zamba2-7b (first pass 1)
])
def test_meta_calls_plan_and_shape_as_before_on_either_pass_1(shape, plan):
    BH, G, d, group, S = shape
    W, ps, H = 16, 16, 4
    q = torch.empty((BH, G, d), device="meta")
    kr = torch.empty((BH, W, d), device="meta")
    n_splits, tps = plan
    scratch = qa_ops._plan(q, kr, -(-S // qa_ops.TILE), group)
    assert scratch[3:] == plan
    assert [tuple(t.shape) for t in scratch[:3]] == [
        (BH, n_splits, G, 2), (BH, n_splits, G, d), (BH, G, d)]
    codes = torch.empty((BH, S, d // 2), dtype=torch.uint8, device="meta")
    scales = torch.empty((BH, S, d // group), device="meta")
    lens = torch.full((BH,), S, dtype=torch.int32, device="meta")
    pools = (codes.reshape(-1, ps, d // 2), scales.reshape(-1, ps,
                                                          d // group))
    table = torch.empty((BH // H, S // ps), dtype=torch.int32,
                        device="meta")
    before = (qa_ops.launches, qa_ops.paged_launches, qa_ops.tc_launches)
    out, lse = qa_ops.quant_decode_attention(
        q, codes, scales, codes, scales, kr, kr, lens, lens, group=group,
        return_lse=True)
    paged = qa_ops.quant_decode_attention_paged(
        q, *pools, *pools, kr, kr, lens, lens, table, group=group,
        page_size=ps, n_kv_heads=H)
    assert [(tuple(t.shape), t.dtype, t.device.type)
            for t in (out, lse, paged)] == [
        ((BH, G, d), torch.float32, "meta"), ((BH, G), torch.float32, "meta"),
        ((BH, G, d), torch.float32, "meta")]
    assert before == (qa_ops.launches, qa_ops.paged_launches,
                      qa_ops.tc_launches)


def test_wrappers_record_their_analytic_cost():
    args = tuple(a.to("meta") for a in _b1_args("cpu"))
    x = torch.empty((40, 64), dtype=torch.bfloat16, device="meta")
    m = torch.empty((64, 64), device="meta")
    with cost.CostCounter() as cc:
        qa_ops.quant_decode_attention(*args, 80, 87, group=32,
                                      return_lse=True)
        sq_ops.srft_quant(x, m, torch.empty(64, device="meta"), group=32)
        sq_ops.srft_dequant(torch.empty((40, 32), dtype=torch.uint8,
                                        device="meta"),
                            torch.empty((40, 2), device="meta"), m, group=32)
    got = [(r.op, r.flops, r.bytes_read, r.bytes_written)
           for r in cc.records if r.kernel]
    want = [("quant_decode_attention",
             cost.kernel_cost_b1(6, 3, 64, 32, 16, 6 * 80, lse=True)),
            ("srft_quant", cost.kernel_cost_b3(40, 64, 32, x_itemsize=2,
                                               matrix=True, lam=True)),
            ("srft_dequant", cost.kernel_cost_b4(40, 64, 32))]
    assert got == [(n, c["flops"], c["bytes_read"], c["bytes_written"])
                   for n, c in want]


def test_kernel_cost_b1_is_chip_smokes_bound_at_check_b1():
    """``chip_smoke.check_b1(flush, g, 8, 2, 128, 32, 16)``: BH 8, G 2,
    d 128, group 32, W 16 at the 4093-token request's last step (4093 +
    64 - 1 tokens); the bytes and FLOPs it handed ``bound()`` before the
    formula moved here."""
    Hkv, G, d, group, W = 8, 2, 128, 32, 16
    total = 4093 + 64 - 1
    plen = total - total % W
    BH = Hkv
    nbytes = (BH * G * d * 4 * 2 + 2 * BH * plen * (d // 2 + d // group * 4)
              + 2 * BH * W * d * 4)
    c = cost.kernel_cost_b1(BH, G, d, group, W, BH * plen)
    assert c["bytes_read"] + c["bytes_written"] == nbytes
    assert c["flops"] == 4.0 * BH * G * d * (plen + W)
    # and the kernel bound that goes with it, on the data-sheet rates
    rec = cost.OpRecord("quant_decode_attention", "float32", c["flops"], 0.0,
                        c["bytes_read"], c["bytes_written"], kernel=True)
    assert roofline.op_bound_s(rec) == max(
        nbytes / roofline.HW.DATASHEET_HBM_BYTES_PER_S,
        c["flops"] / roofline.HW.DATASHEET_FP32_FLOP_PER_S)


def test_step_bound_sums_each_ops_bound_by_dtype():
    a = torch.randn(64, 64, dtype=torch.bfloat16)
    with cost.CostCounter() as cc:
        a @ a
        a.float() @ a.float()
    mm = [r for r in cc.records if r.op == "aten.mm"]
    hw = roofline.HW
    assert roofline.op_bound_s(mm[0]) == max(
        mm[0].nbytes / hw.DATASHEET_HBM_BYTES_PER_S,
        mm[0].flops / hw.DATASHEET_BF16_FLOP_PER_S)
    assert roofline.op_bound_s(mm[1]) == max(
        mm[1].nbytes / hw.DATASHEET_HBM_BYTES_PER_S,
        mm[1].flops / hw.DATASHEET_FP32_FLOP_PER_S)
    assert roofline.step_bound(cc.records) == sum(
        roofline.op_bound_s(r) for r in cc.records)
