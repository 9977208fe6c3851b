"""The audio family of the port (whisper: ``models/encdec.py``) and the
pieces it adds to ``models/common.py``, ``flash.py`` and ``attention.py``,
against the JAX reference on the CPU with the reference's parameters and
rotations bridged in: ``layernorm``, ``sinusoidal_positions``, the
non-causal flash attention over a length that is no multiple of the KV
block, the cross-attention, the reduced whisper ``EncDec`` (teacher-forced
logits, the loss, the KV round-trip hook, prefill + decode through
``Engine`` with the ``(frames, tokens)`` prompt under int4-srft GATHER and
KERNEL and bf16, the read-only cross cache), and the raises that stay.

Tolerances.  A layernorm within one bf16 ulp of the largest output (at
most 2^-7 of it), the positions within 1e-6, flash outputs within 1e-5
(fp32 inputs, sums in another order); model logits within LOGIT_TOL = 5%
of the reference's largest and the loss within RTOL = 1e-3, greedy tokens
equal up to a named near-tie, as ``tests/test_torch_models.py``."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.flash import flash_attention as jflash  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.batch_engine import BatchEngine  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import attention, build_model, common  # noqa: E402
from repro_torch.models.encdec import EncDec  # noqa: E402
from repro_torch.models.flash import flash_attention  # noqa: E402

ARCH = "whisper-large-v3"
ULP = 2.0 ** -7  # one bf16 ulp of the largest is at most 2^-7 of it
LOGIT_TOL = 0.05
RTOL = 1e-3
B, S_ENC, PROMPT, NEW, S_MAX = 2, 40, 20, 12, 64  # decode crosses W = 16
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


def test_layernorm_and_positions_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32) * 0.1,
         "bias": rng.standard_normal(64).astype(np.float32) * 0.1}
    want = jcommon.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x, jnp.bfloat16))
    got = common.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and _rel(want, got) <= ULP
    init = common.layernorm_init(64)
    assert set(init) == {"scale", "bias"} and not init["scale"].any()
    for n, d in ((7, 64), (1500, 1280)):
        want = np.asarray(jcommon.sinusoidal_positions(n, d))
        got = common.sinusoidal_positions(n, d)
        assert got.dtype == torch.float32 and got.shape == (n, d)
        assert np.abs(got.numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(causal):
    """Skv = 40 over kv blocks of 16: the padded tail stays masked."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 9, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, 40, 32)).astype(np.float32)
    v = rng.standard_normal((2, 2, 40, 32)).astype(np.float32)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, q_offset=31, kv_block=16)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          q_offset=31, kv_block=16)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


def test_cross_attention_matches_reference():
    """Queries from x, K/V from the encoder states, no RoPE, not causal."""
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    p = jattention.attention_init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    want, _ = jattention.attention_forward(
        p, jnp.asarray(x, jnp.bfloat16), jcfg,
        cross_kv=jnp.asarray(enc, jnp.bfloat16), kv_block=16)
    got, _ = attention.attention_forward(
        tp, torch.from_numpy(x).bfloat16(), tcfg,
        cross_kv=torch.from_numpy(enc).bfloat16(), kv_block=16)
    assert _rel(want, got) <= ULP


# ----------------------------------------------------------------- EncDec

@functools.lru_cache(maxsize=None)
def _bridged():
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    for f in dataclasses.fields(tcfg):
        assert getattr(jcfg, f.name) == getattr(tcfg, f.name), f.name
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    frames = rng.standard_normal((B, S_ENC, jcfg.d_model)).astype(np.float32)
    model = build_model(tcfg, device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    return jm, jp, model, params, frames, toks


def _t(x):
    return torch.from_numpy(x).long() if x.dtype == np.int32 else \
        torch.from_numpy(x)


def test_structure_and_cross_cache_size():
    """2 + 2 layers, a 65,536-row position table; the cross cache holds
    ((S_enc + W - 1) // W + 1) * W slots, 1520 for whisper's 1500."""
    _, jp, model, params, _, _ = _bridged()
    assert isinstance(model, EncDec)
    assert len(params["enc_layers"]) == len(params["dec_layers"]) == 2
    assert tuple(params["dec_pos"].shape) == (1 << 16, model.cfg.d_model)
    cache = model.init_cache(1, 32, 1500)
    assert cache["cross"][0].s_max == 1520 and cache["self"][0].s_max == 32
    jcache = jbuild_model(jreduced(jget_config(ARCH))).init_cache(1, 32,
                                                                  1500)
    assert jcache["cross"].data.kv.k_packed.shape[-2] == 1520


def _jrots(jm):
    return jm.init_rotations(jax.random.PRNGKey(3))


def _side(jrots_side):
    return {s: {f: np.asarray(getattr(getattr(jrots_side, s), f))
                for f in ("matrix", "lam", "signs")} for s in "kv"}


def _cache_rots(state):
    """A reference cache state's (layer-stacked) rotations as numpy."""
    return {s: {f: np.asarray(getattr(getattr(state.data, f"rot_{s}"), f))
                for f in ("matrix", "lam", "signs")} for s in "kv"}


def _port_rots(jrots):
    return bridge.encdec_rotations({"self_kv": _side(jrots.self_kv),
                                    "cross_kv": _side(jrots.cross_kv)})


@pytest.mark.parametrize("hook", [None, dict(bits=4, scheme="per_group",
                                             group=32)])
def test_forward_and_loss_match_reference(hook):
    jm, jp, model, params, frames, toks = _bridged()
    jrots = _jrots(jm)
    want = jax.jit(lambda p, f, t, r: jm.forward(
        p, f, t, rots=r, kv_quant_cfg=hook, remat=False))(
        jp, jnp.asarray(frames), jnp.asarray(toks), jrots)
    got = model.forward(params, _t(frames), _t(toks), rots=_port_rots(jrots),
                        kv_quant_cfg=hook)
    assert got.shape == want.shape == (B, PROMPT, model.cfg.vocab_size)
    assert _rel(want, got) <= LOGIT_TOL
    if hook is None:
        jl, _ = jax.jit(lambda p, b: jm.loss(p, b, remat=False))(
            jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
        loss, metrics = model.loss(params, {"frames": _t(frames),
                                            "tokens": _t(toks)})
        assert abs(float(loss) - float(jl)) <= RTOL * abs(float(jl))
        assert float(metrics["aux"]) == 0.0


def _reference(jm, jp, frames, toks, policy, backend):
    cache = jm.init_cache(B, S_MAX, S_ENC, policy=policy,
                          key=jax.random.PRNGKey(7))
    logits, cache = jax.jit(jm.prefill)(jp, jnp.asarray(frames),
                                        jnp.asarray(toks), cache)
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
        rots = bridge.encdec_rotations({
            "self_kv": _cache_rots(cache["self"]),
            "cross_kv": _cache_rots(cache["cross"])})
    return np.concatenate(out_t, 1), np.stack(out_l, 1), rots


@pytest.mark.parametrize("policy,backend", CASES)
def test_generate_matches_reference(policy, backend):
    """``Engine.generate`` with the ``(frames, tokens)`` prompt, on a plain
    cache and on one that keeps its lengths on the device: the two equal
    bit for bit and agree with the reference's loop; the cross caches are
    not written after the prefill."""
    jm, jp, model, params, frames, toks = _bridged()
    ref_t, ref_l, rots = _reference(jm, jp, frames, toks, policy, backend)
    tol = LOGIT_TOL * np.abs(ref_l).max()
    eng = Engine(model, backend=backend, kv_block=32)
    out = {}
    for ragged in (False, True):
        cache = model.init_cache(B, S_MAX, S_ENC, policy=policy, rots=rots,
                                 ragged=ragged)
        logits, cache = eng.prefill(params, (_t(frames), _t(toks)), cache)
        cross = [[t.clone() for t in _leaves(st)] for st in cache["cross"]]
        tok0 = logits[:, -1].argmax(-1)[:, None]
        rest, steps, cache = eng.decode(params, tok0, cache, NEW - 1,
                                        return_logits=True)
        assert all(torch.equal(a, b) for st, saved in zip(cache["cross"],
                                                          cross)
                   for a, b in zip(_leaves(st), saved))
        out[ragged] = (torch.cat([tok0, rest], 1),
                       torch.cat([logits[:, -1:], steps], 1), cache)
    assert out[False][2]["pos"] == PROMPT + NEW - 1
    assert out[True][2]["pos"].tolist() == [PROMPT + NEW - 1] * B
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])
    got_t, got_l = out[False][0].numpy(), out[False][1].numpy()
    diverged = np.argwhere(got_t != ref_t)
    n_same = NEW
    if len(diverged):
        b, i = diverged[np.argmin(diverged[:, 1])]
        top2 = np.sort(ref_l[b, i])[-2:]
        assert top2[1] - top2[0] < tol, (
            f"diverged at step {i} with a top-2 gap of {top2[1] - top2[0]}")
        print(f"whisper {policy}/{backend}: near-tie divergence at step {i}")
        n_same = i + 1
    err = np.abs(got_l[:, :n_same] - ref_l[:, :n_same]).max()
    assert err <= tol, f"logits off by {err} > {tol}"


def _leaves(state):
    """A state's KV tensors (codes, scales, rings or raw K/V, lengths)."""
    kv = getattr(state.data, "kv", state.data)
    return [getattr(kv, f.name) for f in dataclasses.fields(kv)
            if isinstance(getattr(kv, f.name), torch.Tensor)]


def test_prefill_step_and_generate_take_the_audio_prompt():
    _, _, model, params, frames, toks = _bridged()
    cache = model.init_cache(B, S_MAX, S_ENC)
    logits, cache = make_prefill_step(model)(
        params, {"frames": _t(frames), "tokens": _t(toks)}, cache)
    assert logits.shape == (B, 1, model.cfg.vocab_size)
    assert cache["pos"] == PROMPT


def test_what_stays_refused():
    _, _, model, params, _, _ = _bridged()
    with pytest.raises(NotImplementedError, match="pure-attention"):
        BatchEngine(model, params, capacity=2, s_max=S_MAX, device="cpu")
    cache = model.init_cache(1, S_MAX, S_ENC)
    tok = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="pure-attention"):
        Engine(model).generate_spec(params, tok, cache, 4, spec_k=4)


def test_serve_cli_serves_whisper_single_stream(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--max-batch", "1", "--requests", "1", "--prompt-len", "16",
                "--new-tokens", "4", "--backend", "kernel"])
    out = capsys.readouterr().out
    assert "single-stream family" in out and "persistent KV" in out
