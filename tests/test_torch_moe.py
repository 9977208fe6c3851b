"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference's ``repro/models/moe.py``, not jitted, on the same bf16 inputs
and bridged weights: routing (top-k with ties to the lower index),
rank-major capacity with the same (token, expert) pairs dropped, the
outputs and the aux loss; ``capacity`` and the group size on tables;
``bridge.lm_params`` on a reference MoE tree, leaf by leaf and bit for
bit; and a ragged ``BatchEngine`` on reduced dbrx, paged == dense.

Tolerances.  Routing, dispatch and combine are equal bit for bit (fp32
one-hots and cumsums of integers; every gate a token sends to an expert
is one product).  The outputs pass through fp32 expert products that
XLA and PyTorch sum in their own orders before the bf16 rounding, so they
are held within Y_TOL of the largest |y| (two bf16 ulps; measured 0), the
aux loss within AUX_TOL (fp32 means of the same probabilities)."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import MoEConfig, get_config, reduced  # noqa: E402
from repro_torch.launch.batch_engine import BatchEngine, Request  # noqa: E402
from repro_torch.models import common, moe  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

D = 64
Y_TOL = 2 ** -7  # relative to max |y|: two bf16 ulps
AUX_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(E, K, group=512, de=32, factor=1.25):
    return (JMoEConfig(n_experts=E, top_k=K, d_expert=de, group_size=group,
                       capacity_factor=factor),
            MoEConfig(n_experts=E, top_k=K, d_expert=de, group_size=group,
                      capacity_factor=factor))


def _layer(E, K, seed, **kw):
    jc, tc = _cfgs(E, K, **kw)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), D, jc)
    return jc, tc, jp, bridge.to_torch(jax.tree.map(np.asarray, jp))


def _x(T, seed, d=D):
    x = np.random.default_rng(seed).standard_normal((1, T, d))
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, bridge.to_torch(np.asarray(xj))


def _ref_routing(jp, xg, jc):
    """The reference's routing steps of ``moe_apply`` (``moe.py:81-86``)."""
    logits = jcommon.dense(jp["router"], xg).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_vals, top_idx = jax.lax.top_k(probs, jc.top_k)
    top_vals = top_vals / jnp.maximum(
        jnp.sum(top_vals, axis=-1, keepdims=True), 1e-9)
    return probs, top_idx, top_vals


def _port_routing(tp, xg, tc):
    probs = torch.softmax(common.dense(tp["router"], xg).float(), dim=-1)
    top_vals, top_idx = moe.top_k(probs, tc.top_k)
    return probs, top_idx, top_vals / top_vals.sum(-1, keepdim=True)


def _compare(jp, tp, jc, tc, xj, xt):
    yj, aj = jmoe.moe_apply(jp, xj, jc, d_model=D)
    yt, at = moe.moe_apply(tp, xt, tc)
    yj = np.asarray(yj.astype(jnp.float32))
    assert yt.dtype == torch.bfloat16 and yt.shape == tuple(yj.shape)
    err = np.abs(yt.float().numpy() - yj).max()
    assert err <= Y_TOL * np.abs(yj).max(), err
    assert abs(float(at) - float(aj)) <= AUX_TOL, (float(at), float(aj))


@pytest.mark.parametrize("E,K", [(4, 2), (16, 4), (128, 8)])
@pytest.mark.parametrize("T", [1, 4, 20, 512, 521])
def test_moe_apply_matches_reference(E, K, T):
    """group_size 512: T = 512 is one group; 521 is prime, so gs = 1 and
    every token fills E x 4 slots."""
    jc, tc, jp, tp = _layer(E, K, E + T)
    xj, xt = _x(T, T)
    gs = moe.group_size(T, tc.group_size)
    assert gs == (1 if T == 521 else T)
    # routing and dispatch / combine: equal bit for bit
    pj, ij, vj = _ref_routing(jp, xj.reshape(T // gs, gs, D), jc)
    pt, it, vt = _port_routing(tp, xt.reshape(T // gs, gs, D), tc)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    C = moe.capacity(gs, K, E, tc.capacity_factor)
    cj, dj = jmoe._dispatch_combine(pj, ij, vj, E, C)
    ct, dt = moe._dispatch_combine(torch.from_numpy(np.array(ij)).long(),
                                   torch.from_numpy(np.array(vj)), E, C)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    _compare(jp, tp, jc, tc, xj, xt)


def test_forced_ties_choose_the_reference_experts():
    """Router columns repeated so that probabilities tie exactly: both
    packages take the lower index first, and the outputs agree."""
    E, K, T = 16, 4, 20
    jc, tc, jp, tp = _layer(E, K, 3)
    w = np.array(jp["router"]["w"].astype(jnp.float32))
    for a, b in ((0, 1), (2, 3), (3, 7), (5, 9), (9, 15)):
        w[:, b] = w[:, a]  # chains: 2 = 3 = 7, 5 = 9 = 15
    jp["router"]["w"] = jnp.asarray(w, jnp.bfloat16)
    tp["router"]["w"] = bridge.to_torch(np.asarray(jp["router"]["w"]))
    xj, xt = _x(T, 4)
    pj, ij, _ = _ref_routing(jp, xj.reshape(1, T, D), jc)
    pt, it, _ = _port_routing(tp, xt.reshape(1, T, D), tc)
    p, idx = np.asarray(pj), np.asarray(ij)
    chosen = np.take_along_axis(p, idx, -1)
    n_ties = int((chosen[..., :, None] == chosen[..., None, :]).sum()
                 - chosen.size)
    assert n_ties > 0, "the router must produce ties among chosen experts"
    np.testing.assert_array_equal(it.numpy(), idx)
    _compare(jp, tp, jc, tc, xj, xt)


def test_overflow_drops_the_same_pairs():
    """Twenty copies of one token in one group: every token picks the same
    two experts, so each takes C = 16 of them and drops 4, at rank 0 and
    rank 1 alike; the port drops the same (token, expert) pairs and counts
    them in ``drop_log``."""
    E, K, T = 4, 2, 20
    jc, tc, jp, tp = _layer(E, K, 5)
    one = np.random.default_rng(6).standard_normal((1, 1, D))
    xj = jnp.asarray(np.repeat(one, T, axis=1), jnp.bfloat16)
    xt = bridge.to_torch(np.asarray(xj))
    C = moe.capacity(T, K, E, tc.capacity_factor)
    assert C == 16
    pj, ij, vj = _ref_routing(jp, xj, jc)
    _, dj = jmoe._dispatch_combine(pj, ij, vj, E, C)
    moe.drop_log = []
    try:
        _, dt = moe._dispatch_combine(
            torch.from_numpy(np.array(ij)).long(),
            torch.from_numpy(np.array(vj)), E, C)
        dropped = [int(t) for t in moe.drop_log]
    finally:
        moe.drop_log = None
    kept = dt.sum(-1).numpy()  # (1, T, E): 1 where (token, expert) is kept
    np.testing.assert_array_equal(kept, np.asarray(dj).sum(-1))
    assert dropped == [2 * (T - C)]
    assert kept[0, C:].sum() == 0 and kept[0, :C].sum() == K * C
    _compare(jp, tp, jc, tc, xj, xt)


@pytest.mark.parametrize("args,want", [
    ((1, 2, 4, 1.25), 4), ((4, 8, 128, 1.25), 4), ((20, 2, 4, 1.25), 16),
    ((23, 2, 4, 1.25), 16), ((32, 2, 4, 1.25), 20), ((512, 4, 16, 1.25), 160),
    ((512, 8, 128, 1.25), 40), ((411, 4, 16, 1.25), 132),
    ((411, 8, 128, 1.25), 36), ((64, 2, 4, 1.0), 32), ((7, 3, 5, 2.0), 12),
])
def test_capacity_table(args, want):
    assert moe.capacity(*args) == jmoe.capacity(*args) == want


@pytest.mark.parametrize("T,max_group,want", [
    (1, 512, 1), (4, 512, 4), (512, 512, 512), (2048, 512, 512),
    (2055, 512, 411), (4093, 512, 1), (1031, 512, 1), (46, 32, 23),
    (1024, 512, 512), (2 * 2055, 512, 411)])
def test_group_size_is_the_reference_divisor(T, max_group, want):
    assert moe.group_size(T, max_group) == want


def test_bridge_splits_moe_leaves_by_layer_bit_for_bit():
    jm = build_model(jreduced(jget_config("dbrx-132b")))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = bridge.lm_params(tree)
    blocks = tree["blocks"]
    assert len(params["blocks"]) == 2
    for i, p in enumerate(params["blocks"]):
        assert "ffn" not in p
        for name in ("router", "w_gate", "w_up", "w_down"):
            want = blocks["moe"][name]["w"][i]
            got = p["moe"][name]["w"]
            assert got.dtype == torch.bfloat16
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
    E, d, de = 4, 128, 64
    assert tuple(params["blocks"][0]["moe"]["w_gate"]["w"].shape) == (E, d, de)
    assert tuple(params["blocks"][0]["moe"]["w_down"]["w"].shape) == (E, de, d)
    assert tuple(params["blocks"][0]["moe"]["router"]["w"].shape) == (d, E)


def test_batch_engine_paged_equals_dense_on_reduced_dbrx():
    """Reduced dbrx (4 experts, top 2) through the ragged BatchEngine:
    decode routes the batch's rows as one group, which the paged and the
    dense layouts build alike, so their streams are equal token for token;
    every page comes back."""
    jm = build_model(jreduced(jget_config("dbrx-132b")))
    params = bridge.lm_params(jax.tree.map(np.asarray,
                                           jm.init(jax.random.PRNGKey(0))))
    model = LM(reduced(get_config("dbrx-132b")), device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, 128, n).astype(np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(((9, 8), (17, 6), (40, 10), (23, 12)))]
    out = {}
    for paged in (False, True):
        eng = BatchEngine(model, params, capacity=3, s_max=64,
                          policy="int4-srft", backend="kernel", kv_block=16,
                          chunk=4, paged=paged, page_size=16, device="cpu")
        out[paged] = {c.rid: c.tokens for c in eng.run(list(reqs))}
    for i in range(len(reqs)):
        assert len(out[True][i]) == reqs[i].max_new_tokens
        np.testing.assert_array_equal(out[True][i], out[False][i])
    stats = eng.pool_stats()
    assert stats["pages_used"] == 0 and stats["peak_pages"] > 0


def test_serve_cli_serves_dbrx_smoke_through_the_batch_engine(tmp_path,
                                                              capsys):
    """``python -m repro_torch.launch.serve --arch dbrx-132b --smoke`` on the
    CPU: the ragged, paged BatchEngine serves every request."""
    from repro_torch.launch import serve

    stats = tmp_path / "s.json"
    serve.main(["--arch", "dbrx-132b", "--smoke", "--device", "cpu",
                "--paged", "--policy", "int4-srft", "--backend", "kernel",
                "--max-batch", "2", "--requests", "3", "--prompt-len", "24",
                "--new-tokens", "4", "--stats-json", str(stats)])
    out = capsys.readouterr().out
    assert "arch=dbrx-132b" in out and "continuous batching" in out
    assert out.count("[done]") == 3
    data = json.loads(stats.read_text())
    assert data["requests_done"] == 3 and data["tokens"] == 12
    assert data["cache"]["pool"]["pages_used"] == 0
