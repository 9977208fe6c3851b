"""The new configs of the port (gemma-7b, qwen3-14b, qwen1.5-110b, dbrx-132b,
llava-next-34b, qwen3-moe-235b-a22b) against the JAX reference, each
``reduced()`` in both packages with every config field equal and the
reference's ``LM.init`` bridged into the port: teacher-forced logits, the
MoE aux loss and the loss (a vlm with 8 patch embeddings), a vlm prefill
that starts with patches, ``Engine.generate`` under int4-srft (GATHER and
KERNEL) and bf16, and one training step of the port on ``smoke_config``.

Tolerances.  Logits within LOGIT_TOL of the reference's largest, as in
``tests/test_torch_engine.py`` (the reference runs under ``jit``, whose
bf16 intermediates keep fp32 precision; the eager port rounds them, and
sums attention and products in other orders).  The aux loss and the loss
within RTOL of the reference's, as ``tests/test_torch_quality.py`` holds
the dense loss: past layer 0 the routers see inputs a few bf16 ulps
apart, so the probabilities the aux loss averages differ by about 1e-4
of it (measured: aux 2.2e-4 of 2.08 on dbrx, loss 1.35e-4 relative on
qwen3-14b); ``tests/test_torch_moe.py`` holds one layer's aux within
1e-6 on equal inputs.  Greedy tokens equal
the reference's, except from a first divergence at a near-tie of the
reference's logits (top-2 gap below the logit tolerance); the test names
the step."""
import dataclasses
import functools

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
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    init_train_state,
    make_train_step,
)
from repro_torch.launch.train import smoke_config  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim.adam import tree_leaves  # noqa: E402

ARCHS = ["gemma-7b", "qwen3-14b", "qwen1.5-110b", "dbrx-132b",
         "llava-next-34b", "qwen3-moe-235b-a22b"]
LOGIT_TOL = 0.05  # relative to max |reference logit|
RTOL = 1e-3  # aux and loss, relative to the reference's
B, PROMPT, NEW, S_MAX, N_PATCHES = 2, 23, 12, 64, 8  # decode crosses W = 16
CASES = [("int4-srft", "gather"), ("int4-srft", "kernel"), ("bf16", "gather")]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(cfg, f):
    v = getattr(cfg, f)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@functools.lru_cache(maxsize=None)
def _bridged(arch):
    """(reference model, its params, the port's model, the bridged params,
    tokens (B, PROMPT), patches (B, N_PATCHES, d) or None) of ``arch``."""
    jcfg = jreduced(jget_config(arch))
    tcfg = reduced(get_config(arch))
    for f in dataclasses.fields(tcfg):
        assert _field(jcfg, f.name) == _field(tcfg, f.name), f.name
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    patches = (rng.standard_normal((B, N_PATCHES, jcfg.d_model))
               .astype(np.float32) if jcfg.family == "vlm" else None)
    model = LM(tcfg, device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    return jm, jp, model, params, toks, patches


def _opt(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_and_loss_match_reference(arch):
    jm, jp, model, params, toks, patches = _bridged(arch)
    jpatch = None if patches is None else jnp.asarray(patches)
    want, jaux = jax.jit(lambda p, t, x: jm.forward(p, t, patches=x,
                                                    remat=False))(
        jp, jnp.asarray(toks), jpatch)
    want = np.asarray(want)
    got, aux = model.forward_aux(params, torch.from_numpy(toks).long(),
                                 patches=_opt(patches))
    assert got.shape == want.shape == (B, PROMPT + (
        0 if patches is None else N_PATCHES), model.cfg.vocab_size)
    err = np.abs(got.numpy() - want).max()
    assert err <= LOGIT_TOL * np.abs(want).max(), err
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert abs(float(aux) - float(jaux)) <= RTOL * abs(float(jaux)), (
        float(aux), float(jaux))
    if model.cfg.moe is not None:
        assert float(aux) > 0

    batch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks).long()}
    if patches is not None:
        batch["patches"], tbatch["patches"] = jpatch, _opt(patches)
    jl, jm_ = jax.jit(lambda p, b: jm.loss(p, b, remat=False))(jp, batch)
    loss, metrics = model.loss(params, tbatch)
    for a, b in ((loss, jl), (metrics["ce"], jm_["ce"]),
                 (metrics["aux"], jm_["aux"])):
        assert abs(float(a) - float(b)) <= RTOL * abs(float(b)), (a, b)


def _reference(jm, jp, toks, policy, backend, patches=None):
    """The reference's per-step greedy loop: (tokens (B, NEW), logits (B,
    NEW, V), the prefilled cache's rotation state)."""
    cache = jm.init_cache(toks.shape[0], S_MAX, policy=policy,
                          key=jax.random.PRNGKey(7))
    logits, cache = jax.jit(lambda p, t, c, x: jm.prefill(p, t, c,
                                                          patches=x))(
        jp, jnp.asarray(toks), cache,
        None if patches is None else jnp.asarray(patches))
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


def _agree_with_reference(got_t, got_l, ref_t, ref_l, tol, what):
    """Equal greedy tokens, or a first divergence at a near-tie of the
    reference's logits; logits within ``tol`` up to that step."""
    diverged = np.argwhere(got_t != ref_t)
    if len(diverged):
        b, i = diverged[np.argmin(diverged[:, 1])]
        top2 = np.sort(ref_l[b, i])[-2:]
        assert top2[1] - top2[0] < tol, (
            f"{what}: greedy tokens diverge at step {i} (row {b}) with a "
            f"top-2 gap of {top2[1] - top2[0]} >= {tol}")
        print(f"{what}: near-tie divergence at step {i}")
    n_same = diverged[:, 1].min() + 1 if len(diverged) else NEW
    err = np.abs(got_l[:, :n_same] - ref_l[:, :n_same]).max()
    assert err <= tol, f"{what}: logits off by {err} > {tol}"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy,backend", CASES)
def test_generate_matches_reference(arch, policy, backend):
    """Text-only prompts (the reference's serving path for every family)."""
    jm, jp, model, params, toks, _ = _bridged(arch)
    ref_t, ref_l, ref_state = _reference(jm, jp, toks, policy, backend)
    tol = LOGIT_TOL * np.abs(ref_l).max()
    eng = Engine(model, backend=backend, kv_block=32)
    cache = model.init_cache(B, S_MAX, policy=policy,
                             rots=_rots(ref_state, policy))
    got_t, got_l, cache = eng.generate(params, torch.from_numpy(toks).long(),
                                       cache, NEW, return_logits=True)
    assert cache["pos"] == PROMPT + NEW - 1
    _agree_with_reference(got_t.numpy(), got_l.numpy(), ref_t, ref_l, tol,
                          f"{model.cfg.name} {policy}/{backend}")


def test_vlm_prefill_with_patches_matches_reference():
    """A vlm prompt of 8 patch embeddings then the tokens: the prefill's
    cache holds P + S positions, and teacher-forced decode steps through
    the int4 KERNEL read agree with the reference's."""
    jm, jp, model, params, toks, patches = _bridged("llava-next-34b")
    ref_t, ref_l, ref_state = _reference(jm, jp, toks, "int4-srft", "kernel",
                                         patches)
    tol = LOGIT_TOL * np.abs(ref_l).max()
    cache = model.init_cache(B, S_MAX, policy="int4-srft",
                             rots=_rots(ref_state, "int4-srft"))
    logits, cache = model.prefill(params, torch.from_numpy(toks).long(),
                                  cache, patches=_opt(patches))
    assert cache["pos"] == N_PATCHES + PROMPT
    forced = [logits[:, -1]]
    for i in range(NEW - 1):
        logits, cache = model.decode_step(
            params, torch.from_numpy(ref_t[:, i:i + 1]).long(), cache,
            backend="kernel", kv_block=32)
        forced.append(logits[:, -1])
    err = np.abs(torch.stack(forced, 1).numpy() - ref_l).max()
    assert err <= tol, f"teacher-forced logits off by {err} > {tol}"


@pytest.mark.parametrize("arch", ["dbrx-132b", "llava-next-34b"])
def test_train_step_on_smoke_config(arch):
    """One step of the port's training step on ``smoke_config`` (a MoE
    keeps its expert width; a vlm trains on patches and tokens): a finite
    loss, every parameter moved."""
    cfg = smoke_config(get_config(arch))
    assert cfg.family == get_config(arch).family
    model = LM(cfg, device="cpu")
    params, opt = init_train_state(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 16))).long()}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(
            rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32))
    new, opt, metrics = make_train_step(model, lr=1e-3)(params, opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert (float(metrics["aux"]) > 0) == (cfg.moe is not None)
    moved = [not torch.equal(a, b)
             for a, b in zip(tree_leaves(params), tree_leaves(new))]
    assert all(moved), f"{moved.count(False)} leaves did not move"
