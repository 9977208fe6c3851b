"""The hybrid family of the port (zamba2: ``models/ssm.py``'s Mamba2 blocks
and the shared attention block of ``models/lm.py``) against the JAX
reference on the CPU, with the reference's parameters and rotations
bridged in: ``mamba2_forward`` / ``mamba2_decode`` (a decode step after a
chunk boundary too), the ``L % chunk`` raise, the reduced zamba2 ``LM``
(teacher-forced logits, the loss, the KV round-trip hook, prefill + decode
through ``Engine`` under int4-srft GATHER and KERNEL and bf16), the cache
that keeps its lengths on the device (what a captured step replays), and
the raises that stay.

Tolerances.  Block states (fp32) within STATE_RTOL = 1e-4 of the
reference's largest; block outputs, which are bf16, within one bf16 ulp
of the largest (at most 2^-7 of it): the SSD sums run in another order
(measured: state 2.8e-5, outputs 1 ulp).  On fp32 inputs and activations
(``COMPUTE_DTYPE`` set to float32 in both packages for the test, their
files unchanged) the outputs too agree within STATE_RTOL.  Model logits
within LOGIT_TOL = 5% of the reference's largest and the loss within
RTOL = 1e-3, as ``tests/test_torch_models.py`` holds the other families
(the reference runs under ``jit``, which keeps bf16 intermediates in
fp32); greedy tokens equal the reference's up to a near-tie (top-2 gap
below the logit tolerance), which the test names."""
import contextlib
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.common as jcommon  # noqa: E402
import repro_torch.models.common as tcommon  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.batch_engine import BatchEngine  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.models import build_model, ssm  # noqa: E402

ARCH = "zamba2-7b"
STATE_RTOL = 1e-4
ULP = 2.0 ** -7  # one bf16 ulp of the largest is at most 2^-7 of it
LOGIT_TOL = 0.05
RTOL = 1e-3
B, PROMPT, NEW, S_MAX = 2, 32, 12, 64  # decode crosses W = 16
CASES = [("int4-srft", "gather"), ("int4-srft", "kernel"), ("bf16", "gather")]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _block():
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    p = jssm.mamba2_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, p, bridge.to_torch(jax.tree.map(np.asarray, p))


@contextlib.contextmanager
def fp32_activations():
    """Both packages' activations in fp32 (params stay bf16)."""
    saved = jcommon.COMPUTE_DTYPE, tcommon.COMPUTE_DTYPE
    jcommon.COMPUTE_DTYPE, tcommon.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        yield
    finally:
        jcommon.COMPUTE_DTYPE, tcommon.COMPUTE_DTYPE = saved


@pytest.mark.parametrize("fp32", [False, True])
@pytest.mark.parametrize("L", [16, 256, 512])
def test_mamba2_forward_and_decode_match_reference(L, fp32):
    """One chunk (L = 16 < chunk), one chunk of 256, two chunks; then a
    decode step from the reference's final state, after the boundary.
    With ``fp32`` on fp32 inputs and activations (the conv state too),
    where the outputs agree within STATE_RTOL as well."""
    jcfg, tcfg, p, tp = _block()
    rng = np.random.default_rng(L)
    u = rng.standard_normal((2, L, jcfg.d_model)).astype(np.float32)
    u1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if fp32 else (jnp.bfloat16,
                                                          torch.bfloat16)
    out_tol = STATE_RTOL if fp32 else ULP
    with fp32_activations() if fp32 else contextlib.nullcontext():
        jy, jst = jax.jit(lambda p, u: jssm.mamba2_forward(p, u, jcfg))(
            p, jnp.asarray(u, jdt))
        y, st = ssm.mamba2_forward(tp, torch.from_numpy(u).to(tdt), tcfg)
        jy1, jst1 = jssm.mamba2_decode(p, jnp.asarray(u1, jdt), jcfg, jst)
        start = ssm.SSMState(torch.from_numpy(np.array(jst.ssd)),
                             bridge.to_torch(np.asarray(jst.conv)))
        y1, st1 = ssm.mamba2_decode(tp, torch.from_numpy(u1).to(tdt), tcfg,
                                    start)
    assert y.dtype == st.conv.dtype == tdt and st.ssd.dtype == torch.float32
    assert _rel(jy, y) <= out_tol
    assert _rel(jst.ssd, st.ssd) <= STATE_RTOL
    assert _rel(jst.conv, st.conv) <= out_tol
    assert _rel(jy1, y1) <= out_tol
    assert _rel(jst1.ssd, st1.ssd) <= STATE_RTOL
    # a shift of the window and the new projection: bit equal in bf16
    assert _rel(jst1.conv, st1.conv) <= (STATE_RTOL if fp32 else 0.0)


def test_mamba2_refuses_a_length_off_the_chunk():
    """Padding would change the final state: the reference asserts, the
    port raises."""
    jcfg, tcfg, p, tp = _block()
    u = np.zeros((1, 300, jcfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jssm.mamba2_forward(p, jnp.asarray(u, jnp.bfloat16), jcfg)
    with pytest.raises(ValueError, match="chunk"):
        ssm.mamba2_forward(tp, torch.from_numpy(u).bfloat16(), tcfg)


def test_segsum_matches_reference():
    dA = -np.random.default_rng(0).random((2, 3, 8)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(dA)))
    got = ssm._segsum(torch.from_numpy(dA)).numpy()
    assert np.array_equal(np.isinf(want), np.isinf(got))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-6


# ----------------------------------------------------------------- the LM

@functools.lru_cache(maxsize=None)
def _bridged():
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    for f in dataclasses.fields(tcfg):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    model = build_model(tcfg, device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    return jm, jp, model, params, toks


def test_structure_and_bridge():
    """n_super groups of P blocks, the trailing ones, ONE shared block;
    zamba2-7b fires it 13 times (kv_group 28 at d 112)."""
    jm, jp, model, params, _ = _bridged()
    P = model.cfg.shared_attn_period
    assert len(params["mamba_super"]) == 1 and len(
        params["mamba_super"][0]) == P
    assert len(params["mamba_rem"]) == 1
    assert "blocks" not in params and isinstance(params["shared_attn"], dict)
    assert (sum(np.asarray(a).size for a in jax.tree.leaves(jp))
            == sum(t.numel() for t in bridge_leaves(params)))
    full = build_model(get_config(ARCH), device="cpu")
    assert full.n_attn_layers == 13 == jbuild_model(
        jget_config(ARCH)).n_attn_layers
    assert full.cfg.kv_group == 28 and full.cfg.head_dim == 112
    rots = model.init_rotations(torch.Generator().manual_seed(0))
    assert len(rots) == model.n_attn_layers == 1


def bridge_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in bridge_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in bridge_leaves(v)]
    return [tree]


def _jrots(jm):
    return jm.init_rotations(jax.random.PRNGKey(3))


def _port_rots(jrots):
    return bridge.rotations({s: {f: np.asarray(getattr(getattr(jrots, s), f))
                                 for f in ("matrix", "lam", "signs")}
                             for s in "kv"})


@pytest.mark.parametrize("hook", [None, dict(bits=4, scheme="per_group",
                                             group=28)])
def test_forward_and_loss_match_reference(hook):
    """Teacher-forced logits (plain, and through the KV round-trip hook
    with one rotation pair per firing), and the loss."""
    jm, jp, model, params, toks = _bridged()
    jrots = _jrots(jm)
    want, _ = jax.jit(lambda p, t, r: jm.forward(
        p, t, rots=r, kv_quant_cfg=hook, remat=False))(
        jp, jnp.asarray(toks), jrots)
    got = model.forward(params, torch.from_numpy(toks).long(),
                        rots=_port_rots(jrots), kv_quant_cfg=hook)
    assert got.shape == want.shape == (B, PROMPT, model.cfg.vocab_size)
    assert _rel(want, got) <= LOGIT_TOL
    if hook is None:
        jl, _ = jax.jit(lambda p, t: jm.loss(p, {"tokens": t},
                                             remat=False))(
            jp, jnp.asarray(toks))
        loss, metrics = model.loss(params,
                                   {"tokens": torch.from_numpy(toks).long()})
        assert abs(float(loss) - float(jl)) <= RTOL * abs(float(jl))
        assert float(metrics["aux"]) == 0.0


def _reference(jm, jp, toks, policy, backend):
    """The reference's per-step greedy loop: (tokens (B, NEW), logits (B,
    NEW, V), its cache's rotations bridged)."""
    cache = jm.init_cache(toks.shape[0], S_MAX, policy=policy,
                          key=jax.random.PRNGKey(7))
    logits, cache = jax.jit(jm.prefill)(jp, jnp.asarray(toks), cache)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out_t, out_l = [np.asarray(tok)], [np.asarray(logits[:, -1])]
    step = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, backend=backend,
                                                  kv_block=32))
    for _ in range(NEW - 1):
        logits, cache = step(jp, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out_t.append(np.asarray(tok))
        out_l.append(np.asarray(logits[:, -1]))
    rots = None
    if policy == "int4-srft":
        d = cache["attn"].data
        rots = bridge.rotations({
            s: {f: np.asarray(getattr(getattr(d, f"rot_{s}"), f))
                for f in ("matrix", "lam", "signs")} for s in "kv"})
    return np.concatenate(out_t, 1), np.stack(out_l, 1), rots


def agree_with_reference(got_t, got_l, ref_t, ref_l, tol, what):
    """Equal greedy tokens, or a first divergence at a near-tie of the
    reference's logits; logits within ``tol`` up to that step."""
    diverged = np.argwhere(got_t != ref_t)
    n_same = ref_t.shape[1]
    if len(diverged):
        b, i = diverged[np.argmin(diverged[:, 1])]
        top2 = np.sort(ref_l[b, i])[-2:]
        assert top2[1] - top2[0] < tol, (
            f"{what}: greedy tokens diverge at step {i} (row {b}) with a "
            f"top-2 gap of {top2[1] - top2[0]} >= {tol}")
        print(f"{what}: near-tie divergence at step {i}")
        n_same = i + 1
    err = np.abs(got_l[:, :n_same] - ref_l[:, :n_same]).max()
    assert err <= tol, f"{what}: logits off by {err} > {tol}"


@pytest.mark.parametrize("policy,backend", CASES)
def test_generate_matches_reference(policy, backend):
    """``Engine.generate`` on a plain cache and on one that keeps its
    lengths on the device (``ragged=True``, what the graph replays): the
    two equal bit for bit, and both agree with the reference's loop."""
    jm, jp, model, params, toks = _bridged()
    ref_t, ref_l, rots = _reference(jm, jp, toks, policy, backend)
    tol = LOGIT_TOL * np.abs(ref_l).max()
    eng = Engine(model, backend=backend, kv_block=32)
    out = {}
    for ragged in (False, True):
        cache = model.init_cache(B, S_MAX, policy=policy, rots=rots,
                                 ragged=ragged)
        got_t, got_l, cache = eng.generate(
            params, torch.from_numpy(toks).long(), cache, NEW,
            return_logits=True)
        out[ragged] = (got_t, got_l, cache)
    assert out[False][2]["pos"] == PROMPT + NEW - 1
    pos = out[True][2]["pos"]
    assert pos.tolist() == [PROMPT + NEW - 1] * B
    assert all(st.length.tolist() == [PROMPT + NEW - 1] * B
               for st in out[True][2]["attn"])
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])
    for a, b in zip(model.recurrent_states(out[False][2]),
                    model.recurrent_states(out[True][2])):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    agree_with_reference(out[False][0].numpy(), out[False][1].numpy(),
                         ref_t, ref_l, tol, f"zamba2 {policy}/{backend}")


def test_decode_updates_recurrent_state_in_place():
    """A captured step replays fixed addresses: prefill and decode keep
    every recurrent and length tensor where it was."""
    _, _, model, params, toks = _bridged()
    cache = model.init_cache(B, S_MAX, ragged=True)
    before = [t.data_ptr() for t in model.step_state(cache)]
    assert len(before) == 1 + 1 + 2 * model.cfg.n_layers
    logits, cache = model.prefill(params, torch.from_numpy(toks).long(),
                                  cache)
    model.decode_step(params, logits[:, -1].argmax(-1)[:, None], cache,
                      backend="kernel")
    assert [t.data_ptr() for t in model.step_state(cache)] == before


def test_what_stays_refused():
    """Admission at different lengths, paged caches, chunked prefill,
    verify, active masks and spec: the reference's raises."""
    _, _, model, params, toks = _bridged()
    with pytest.raises(NotImplementedError, match="pure-attention"):
        BatchEngine(model, params, capacity=2, s_max=S_MAX, device="cpu")
    with pytest.raises(NotImplementedError, match="pure-attention"):
        model.init_cache(2, S_MAX, ragged=True, n_pages=9, page_size=16)
    cache = model.init_cache(1, S_MAX, ragged=True)
    raw = torch.zeros(1, 1, model.cfg.n_kv_heads, S_MAX, model.cfg.head_dim)
    tok = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="pure-attention"):
        model.prefill_chunk(params, torch.zeros((1, 16), dtype=torch.long),
                            cache, raw, raw)
    with pytest.raises(NotImplementedError, match="pure-attention"):
        model.decode_verify(params, torch.zeros((1, 4), dtype=torch.long),
                            cache)
    with pytest.raises(NotImplementedError, match="pure-attention"):
        model.decode_step(params, tok, cache,
                          active=torch.ones(1, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="pure-attention"):
        Engine(model).generate_spec(params, tok, cache, 4, spec_k=4)


def test_serve_cli_serves_the_hybrid_single_stream(capsys):
    """The closed-loop path through ``Engine`` (the reference's
    ``_serve_single_stream``), its notes for --http / --paged /
    --prefill-chunk, and its SystemExit on --spec-k."""
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--max-batch",
            "2", "--requests", "2", "--prompt-len", "16", "--new-tokens",
            "4", "--policy", "int4-srft", "--backend", "kernel"]
    serve.main(argv + ["--paged", "--prefill-chunk", "16"])
    out = capsys.readouterr().out
    assert "--paged needs a pure-attention family" in out
    assert "--prefill-chunk needs the continuous-batching" in out
    assert "single-stream family" in out and "3.20x vs bf16" in out
    with pytest.raises(SystemExit, match="--spec-k requires"):
        serve.main(argv + ["--spec-k", "4"])
