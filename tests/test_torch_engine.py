"""The slice as a whole: the port's ``Engine.generate`` (prefill + greedy
decode through the cache policy) against the JAX reference, on weights
and rotations bridged from the reference's model and cache.

Per-step logits are compared teacher-forced (the port decodes the
reference's tokens), within LOGIT_TOL of the reference's largest logit:
the reference runs under ``jit``, where XLA keeps bf16 intermediates in
fp32 (excess precision), while the port rounds every bf16 activation, so
the two differ by a few bf16 ulps per layer.  Greedy tokens from the
port's own ``Engine.generate`` must agree, except where the reference's
top-2 gap at the first diverging step is below that tolerance; the test
names that step."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.engine import Engine, generate  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

# relative to max |reference logit| (see module doc); the largest error
# measured on these cases was 0.029 of it
LOGIT_TOL = 0.05
B, PROMPT, NEW, S_MAX = 2, 23, 20, 64  # decode crosses the W=16 flush

CASES = [("int4-srft", "gather"), ("int4-srft", "kernel"), ("bf16", "gather")]


def _configs(name):
    if name == "smol-d64":
        return jget_config(name), get_config(name)
    return (jreduced(jget_config("internlm2-1.8b")),
            reduced(get_config("internlm2-1.8b")))


@pytest.fixture(scope="module", params=["smol-d64", "internlm2-1.8b-reduced"])
def bridged(request):
    jcfg, tcfg = _configs(request.param)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "rope_theta", "kv_group", "kv_window",
              "tie_embeddings", "ffn_activation"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    model = LM(tcfg, device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    return jm, jp, model, params, toks


def _reference(jm, jp, toks, policy, backend):
    """Per-step loop of the reference: (tokens (B, NEW), logits (B, NEW, V),
    the cache as prefilled, for its rotations); B is ``toks``'s."""
    cache = jm.init_cache(toks.shape[0], S_MAX, policy=policy,
                          key=jax.random.PRNGKey(7))
    logits, cache = jax.jit(jm.prefill)(jp, jnp.asarray(toks), cache)
    rots = cache["attn"].data
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out_t, out_l = [np.asarray(tok)], [np.asarray(logits[:, -1])]
    step = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, backend=backend,
                                                  kv_block=32))
    for _ in range(NEW - 1):
        logits, cache = step(jp, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out_t.append(np.asarray(tok))
        out_l.append(np.asarray(logits[:, -1]))
    return np.concatenate(out_t, 1), np.stack(out_l, 1), rots


def _rots(data, policy):
    if policy != "int4-srft":
        return None
    return bridge.rotations({
        side: {f: np.asarray(getattr(getattr(data, f"rot_{side}"), f))
               for f in ("matrix", "lam", "signs")}
        for side in ("k", "v")})


@pytest.mark.parametrize("policy,backend", CASES)
def test_generate_matches_reference(bridged, policy, backend):
    jm, jp, model, params, toks = bridged
    ref_t, ref_l, ref_state = _reference(jm, jp, toks, policy, backend)
    rots = _rots(ref_state, policy)
    tol = LOGIT_TOL * np.abs(ref_l).max()
    prompt = torch.from_numpy(toks).long()

    # teacher-forced: the port's decode_step on the reference's tokens
    cache = model.init_cache(B, S_MAX, policy=policy, rots=rots)
    logits, cache = model.prefill(params, prompt, cache)
    forced = [logits[:, -1]]
    for i in range(NEW - 1):
        logits, cache = model.decode_step(
            params, torch.from_numpy(ref_t[:, i:i + 1]).long(), cache,
            backend=backend, kv_block=32)
        forced.append(logits[:, -1])
    err = np.abs(torch.stack(forced, 1).numpy() - ref_l).max()
    assert err <= tol, f"teacher-forced logits off by {err} > {tol}"

    # free-running: Engine.generate's own greedy tokens
    eng = Engine(model, backend=backend, kv_block=32)
    cache = model.init_cache(B, S_MAX, policy=policy, rots=rots)
    got_t, got_l, cache = eng.generate(params, prompt, cache, NEW,
                                       return_logits=True)
    assert cache["pos"] == PROMPT + NEW - 1
    _agree_with_reference(got_t.numpy(), got_l.numpy(), ref_t, ref_l, tol,
                          f"{policy}/{backend}")


def _agree_with_reference(got_t, got_l, ref_t, ref_l, tol, what):
    """Greedy tokens equal the reference's, except from a first divergence
    at a near-tie (top-2 gap below ``tol``); logits within ``tol`` up to
    and including that step."""
    diverged = np.argwhere(got_t != ref_t)
    if len(diverged):
        b, i = diverged[np.argmin(diverged[:, 1])]
        top2 = np.sort(ref_l[b, i])[-2:]
        assert top2[1] - top2[0] < tol, (
            f"greedy tokens diverge at step {i} (row {b}) with a top-2 gap "
            f"of {top2[1] - top2[0]} >= {tol}")
        print(f"{what}: near-tie divergence at step {i}")
    n_same = diverged[:, 1].min() + 1 if len(diverged) else NEW
    err = np.abs(got_l[:, :n_same] - ref_l[:, :n_same]).max()
    assert err <= tol


# within the port, the ragged single stream runs the same arithmetic as
# the plain one but for per-row masks and the ring quantized every step;
# relative to the largest logit
RAGGED_TOL = 1e-5


@pytest.mark.parametrize("policy,backend", CASES)
def test_single_stream_on_a_ragged_cache(bridged, policy, backend):
    """The single stream on a ragged batch-1 cache (device lengths: the
    form a CUDA graph replays) equals the plain-length single stream
    within the port (tokens equal, logits within RAGGED_TOL of the largest
    logit) and agrees with the reference's per-step loop at LOGIT_TOL."""
    jm, jp, model, params, toks = bridged
    toks = toks[:1]
    ref_t, ref_l, ref_state = _reference(jm, jp, toks, policy, backend)
    rots = _rots(ref_state, policy)
    prompt = torch.from_numpy(toks).long()
    eng = Engine(model, backend=backend, kv_block=32)
    out = {}
    for ragged in (False, True):
        cache = model.init_cache(1, S_MAX, policy=policy, rots=rots,
                                 ragged=ragged)
        out[ragged] = eng.generate(params, prompt, cache, NEW,
                                   return_logits=True)
    (plain_t, plain_l, _), (rag_t, rag_l, cache) = out[False], out[True]
    assert torch.equal(cache["pos"], torch.tensor([PROMPT + NEW - 1],
                                                  dtype=torch.int32))
    assert all(torch.equal(st.lengths, cache["pos"]) for st in cache["attn"])
    assert torch.equal(rag_t, plain_t)
    err = (rag_l - plain_l).abs().max().item()
    assert err <= RAGGED_TOL * plain_l.abs().max().item(), err
    _agree_with_reference(rag_t.numpy(), rag_l.numpy(), ref_t, ref_l,
                          LOGIT_TOL * np.abs(ref_l).max(),
                          f"ragged {policy}/{backend}")


def test_graph_mode_refuses_the_cpu_and_plain_caches():
    """CUDA graphs are a card path: ``graph=True`` on a CPU model or engine
    raises; on a CUDA model the graph path refuses a plain cache (its
    length is a host int) and sampling without an explicit generator
    before touching the card."""
    from repro_torch.launch.batch_engine import BatchEngine
    from repro_torch.launch.engine import Sampler

    cfg = get_config("smol-d64")
    cpu = LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        Engine(cpu, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        BatchEngine(cpu, {}, capacity=1, s_max=32, device="cpu", graph=True)
    assert not Engine(cpu).graph
    assert not BatchEngine(cpu, {}, capacity=1, s_max=32, device="cpu").graph

    eng = Engine(LM(cfg, device="cuda"))  # the default mode on a card
    assert eng.graph
    tok = torch.zeros((1, 1), dtype=torch.long)
    plain = cpu.init_cache(1, 32, policy="bf16")
    with pytest.raises(ValueError, match="ragged=True"):
        eng.decode({}, tok, plain, 4)
    ragged = cpu.init_cache(1, 32, policy="bf16", ragged=True)
    hot = Engine(LM(cfg, device="cuda"), sampler=Sampler(temperature=1.0))
    with pytest.raises(ValueError, match="Generator"):
        hot.decode({}, tok, ragged, 4)


def test_module_generate_and_backends_agree(bridged):
    """Module-level ``generate`` equals ``Engine.generate``; within the
    port, KERNEL (plain B1 here) and GATHER agree to 1% of the largest
    logit (their fp32 attention outputs differ by ~1e-6, which can flip a
    bf16 rounding downstream)."""
    _, _, model, params, toks = bridged
    prompt = torch.from_numpy(toks).long()
    outs = {}
    for backend in ("gather", "kernel"):
        cache = model.init_cache(B, S_MAX, policy="int4-srft",
                                 generator=torch.Generator().manual_seed(3))
        outs[backend] = Engine(model, backend=backend).generate(
            params, prompt, cache, 6, return_logits=True)
    lk, lg = outs["kernel"][1].numpy(), outs["gather"][1].numpy()
    np.testing.assert_allclose(lk, lg, atol=1e-2 * np.abs(lg).max())
    cache = model.init_cache(B, S_MAX, policy="int4-srft",
                             generator=torch.Generator().manual_seed(3))
    toks2, _ = generate(params, prompt, cache, 6, model=model,
                        backend="gather")
    assert torch.equal(toks2, outs["gather"][0])


def test_entry_points_refuse_a_silent_cpu_path(monkeypatch):
    """Without a card, every entry point raises unless asked for the CPU:
    the model, both policies' ``init_state`` / ``init_paged`` and
    ``BatchEngine``."""
    from repro_torch.core.cache_api import get_policy
    from repro_torch.launch.batch_engine import BatchEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(get_config("smol-d64"))
    for name in ("bf16", "int4-srft"):
        pol = get_policy(name)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pol.init_state(1, 1, 32, 64)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pol.init_paged(1, 1, 32, 64, n_pages=3, page_size=16)
        st = pol.init_state(1, 1, 32, 64, device="cpu", ragged=True)
        assert st.lengths.device.type == "cpu"
    model = LM(get_config("smol-d64"), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchEngine(model, {}, capacity=1, s_max=32)
    eng = BatchEngine(model, {}, capacity=1, s_max=32, device="cpu")
    assert eng.device.type == "cpu"
