"""Port parity for the quality path, on the CPU: B4 (unpack + dequantize +
inverse rotation; its wrapper runs the plain version on CPU tensors), the
quantizer schemes, the KV round-trip hook, static lambda, the outlier
patch, the synthetic corpus, the teacher-forced forward, ``collect_kv``,
hook PPL, the loss and its gradients, AdamW and a short training run, and
``kernel_quality`` end to end.  Inputs are made with numpy from a seed (or
by the reference's own init, bridged) and go through the JAX function
(Pallas kernels in interpret mode, the default off-TPU) and its port."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import hooks as jhooks  # noqa: E402
from repro.core import outliers as jout  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import transforms as jtf  # noqa: E402
from repro.data import DataIterator as JDataIterator  # noqa: E402
from repro.data import SyntheticCorpus as JCorpus  # noqa: E402
from repro.kernels.srft_quant import ops as jops  # noqa: E402
from repro.kernels.srft_quant import ref as jref  # noqa: E402
from repro.kernels.srft_quant.srft_quant import srft_dequant_fwd  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.benchmarks import common as bcommon  # noqa: E402
from repro_torch.benchmarks import kernel_quality  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import calibrate, hooks, outliers, quant  # noqa: E402
from repro_torch.core.transforms import Rotation, make_rotation  # noqa: E402
from repro_torch.data import DataIterator, SyntheticCorpus  # noqa: E402
from repro_torch.kernels.srft_quant import ops as sq_ops  # noqa: E402
from repro_torch.kernels.srft_quant import ref as sq_ref  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.optim.adam import tree_leaves, tree_map  # noqa: E402

# Codes may differ by +-1 only where y/scale lies within this distance of
# a .5 boundary (the frameworks sum the d-term rotation in different
# orders, ~1e-6 relative); at most this share of all codes may flip.
TIE_BAND = 1e-4
MAX_FLIP_SHARE = 1e-3
# the JAX kernel test's sweep (tests/test_kernels.py), first six, plus the
# mixed-radix head_dim
B4_SWEEP = [(64, 32, 4, 256), (64, 16, 4, 128), (64, 64, 4, 64),
            (128, 32, 4, 256), (128, 16, 8, 128), (128, 128, 4, 64),
            (112, 28, 4, 96)]
SCHEMES = ["per_token", "per_tensor", "per_group", "per_channel",
           "per_channel_group"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny eager ops run ~10x slower with many intra-op threads under
    xdist; the tests pin torch to one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jrot(d, seed, lam=True):
    r = jtf.make_rotation("srft", jax.random.PRNGKey(seed), d)
    if lam:
        lam_v = np.exp(0.3 * np.random.default_rng(seed).standard_normal(d))
        r = jtf.Rotation(r.matrix, jnp.asarray(lam_v, jnp.float32), r.signs,
                         r.kind)
    return r


def _trot(jrot):
    return Rotation(_t(jrot.matrix), _t(jrot.lam), _t(jrot.signs), jrot.kind)


# ---------------------------------------------------------------------- B4

@pytest.mark.parametrize("d,group,bits,n", B4_SWEEP)
def test_b4_plain_matches_reference_and_interpret_kernel(d, group, bits, n):
    """On the reference's own codes: the port's B4 (plain on the CPU) and
    ``dequantize_rotate`` against ``srft_dequant_ref`` and the
    interpret-mode ``srft_dequant_fwd``, atol 1e-5 (the JAX kernel test's
    bar; fp32 sums of d terms in another order); then the round-trip
    error bound of that test."""
    jrot = _jrot(d, d + 7)
    x = np.random.default_rng(n + d).standard_normal((n, d)).astype(
        np.float32)
    pk, sc = jops.rotate_quantize(jnp.asarray(x), jrot, group=group,
                                  bits=bits)
    minv = jref.fold_inverse_matrix(jrot)
    want_ref = np.asarray(jref.srft_dequant_ref(pk, sc, minv, group=group,
                                                bits=bits))
    tile = n if n % 64 else 64
    want_krn = np.asarray(srft_dequant_fwd(pk, sc, minv, group=group,
                                           bits=bits, row_tile=tile))
    got = sq_ops.srft_dequant(_t(pk), _t(sc), _t(minv), group=group,
                              bits=bits).numpy()
    got_rot = sq_ops.dequantize_rotate(
        _t(pk).reshape(2, n // 2, -1), _t(sc).reshape(2, n // 2, -1),
        _trot(jrot), group=group, bits=bits)
    assert got.dtype == np.float32 and got_rot.shape == (2, n // 2, d)
    for want in (want_ref, want_krn):
        np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got_rot.reshape(n, d).numpy(), want_ref,
                               atol=1e-5)
    assert np.abs(got - x).max() < (1.5 if bits == 4 else 0.1)


def test_fold_inverse_matrix_matches_reference():
    """Elementwise division and a transpose: within 1e-7 relative, with a
    lambda below the 1e-6 clamp."""
    jrot = _jrot(64, 5)
    lam = np.array(jrot.lam)
    lam[3] = 1e-9
    jrot = jtf.Rotation(jrot.matrix, jnp.asarray(lam), jrot.signs, jrot.kind)
    got = sq_ref.fold_inverse_matrix(_trot(jrot)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.fold_inverse_matrix(jrot)),
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize("seed,d,group", [(0, 64, 32), (7, 64, 16),
                                          (13, 128, 32), (29, 128, 64),
                                          (41, 256, 32)])
def test_property_kernel_roundtrip_error_bounded(seed, d, group):
    """The reference property on the port's B3 (folded) -> B4: per vector,
    ||x - rt(x)||_2 <= 0.5 * sqrt(group * sum(scale^2)) + 1e-4 (half an
    LSB per coordinate, rotated back by an orthonormal map)."""
    g = torch.Generator().manual_seed(seed)
    rot = make_rotation("srft", g, d)
    x = _t(np.random.default_rng(seed).standard_normal((64, d)).astype(
        np.float32))
    pk, sc = sq_ops.srft_quant(x, sq_ref.fold_matrix(rot), group=group)
    xr = sq_ops.dequantize_rotate(pk, sc, rot, group=group)
    err = (xr - x).norm(dim=-1)
    bound = 0.5 * (sc.square().sum(-1) * group).sqrt() + 1e-4
    assert bool((err <= bound).all())


def test_b4_wrapper_refuses_other_devices_and_bad_codes():
    pk = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    sc = torch.zeros((4, 2), device="meta")
    minv = torch.zeros((64, 64), device="meta")
    with pytest.raises(ValueError):  # the matrix on another device
        sq_ops.srft_dequant(pk, sc, torch.zeros((64, 64)))
    with pytest.raises(ValueError):  # int8 codes where int4 are packed
        sq_ops.srft_dequant(pk.to(torch.int8), sc, minv)
    before = sq_ops.dequant_launches
    # meta (the cost census's device) checks and allocates, launches nothing
    out = sq_ops.srft_dequant(pk, sc, minv)
    assert (out.shape, out.dtype, out.device.type) == ((4, 64), torch.float32,
                                                       "meta")
    assert sq_ops.dequant_launches == before
    sq_ops.srft_dequant(torch.zeros((4, 32), dtype=torch.uint8),
                        torch.ones((4, 2)), torch.eye(64))
    assert sq_ops.dequant_launches == before  # plain versions do not count


# ----------------------------------------------------------- quantizers

@pytest.mark.parametrize("scheme", ["per_token", "per_tensor", "per_group"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantizers_match_reference(scheme, bits):
    """Same absmax and the same IEEE division: codes equal, scales within
    rtol 1e-6, dequantized values within rtol 1e-6."""
    x = 3.0 * np.random.default_rng(bits).standard_normal((3, 5, 64)).astype(
        np.float32)
    q = quant.quantize(_t(x), bits, scheme, group=16)
    jq = jquant.quantize(jnp.asarray(x), bits, scheme, group=16)
    np.testing.assert_array_equal(q.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_allclose(q.scales.numpy(), np.asarray(jq.scales),
                               rtol=1e-6)
    np.testing.assert_allclose(
        quant.dequantize(q, scheme, group=16).numpy(),
        np.asarray(jquant.dequantize(jq, scheme, group=16)), rtol=1e-6)


def _scheme_quant(mod, y, scheme, bits, group):
    if scheme in ("per_token", "per_channel"):
        return mod.quantize_per_token(y, bits)
    if scheme == "per_tensor":
        return mod.quantize_per_tensor(y, bits)
    return mod.quantize_per_group(y, bits, group)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("bits", [4, 8])
def test_kv_roundtrip_matches_reference(scheme, bits):
    """The hook on bridged bf16 K/V with scaled rotations.  Inside the
    hook, codes are equal except +-1 at .5 ties (TIE_BAND, float64 y);
    outputs of vectors whose codes agree are equal up to one bf16 ulp
    (the inverse rotation sums in another order before the bf16 cast)."""
    d, group = 64, 32
    rng = np.random.default_rng(len(scheme) + bits)
    k = rng.standard_normal((2, 2, 24, d)).astype(np.float32)
    v = rng.standard_normal((2, 2, 24, d)).astype(np.float32)
    k[..., 3] *= 20.0  # an outlier channel, as the benchmarks inject
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    kt, vt = bridge.to_torch(np.asarray(kj)), bridge.to_torch(np.asarray(vj))
    jrk, jrv = _jrot(d, 1), _jrot(d, 2)
    kw = dict(bits=bits, scheme=scheme, group=group)
    want = jhooks.kv_roundtrip(kj, vj, jrk, jrv, **kw)
    got = hooks.make_roundtrip(_trot(jrk), _trot(jrv), **kw)(kt, vt)
    for x, xt, jr, w, g in zip((kj, vj), (kt, vt), (jrk, jrv), want, got):
        assert g.dtype == torch.bfloat16 and g.shape == xt.shape
        tq = _scheme_quant(quant, _trot(jr).forward(xt), scheme, bits, group)
        jq = _scheme_quant(jquant, jr.forward(x), scheme, bits, group)
        diff = tq.codes.numpy().astype(np.int32) - np.asarray(jq.codes)
        y64 = (np.asarray(x.astype(jnp.float32), np.float64)
               @ np.asarray(jr.matrix, np.float64).T) * np.asarray(jr.lam)
        s = np.asarray(jq.scales, np.float64)
        s = np.repeat(s, group, -1) if scheme in (
            "per_group", "per_channel_group") else s
        near_tie = np.abs(np.abs(y64 / s) % 1.0 - 0.5) < TIE_BAND
        assert np.abs(diff).max() <= 1
        assert not np.any((diff != 0) & ~near_tie)
        assert (diff != 0).mean() <= MAX_FLIP_SHARE
        same = ~(diff != 0).any(-1)
        gv = g.float().numpy()[same]
        wv = np.asarray(w.astype(jnp.float32))[same]
        np.testing.assert_allclose(gv, wv, rtol=2 ** -7,
                                   atol=1e-5 * np.abs(wv).max())


def test_static_lambda_matches_reference():
    """Per-channel max of |B x| over the window: within rtol 1e-6 (the
    rotation's sums in another order)."""
    jrot = _jrot(128, 3, lam=False)
    x = np.random.default_rng(3).standard_normal((2, 2, 40, 128)).astype(
        np.float32)
    x[..., 5] *= 30.0
    lam = calibrate.static_lambda(_trot(jrot), _t(x))
    jlam = jcal.static_lambda(jrot, jnp.asarray(x))
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-6)
    rot = calibrate.apply_static_lambda(_trot(jrot), lam.double())
    assert rot.lam.dtype == torch.float32 and rot.matrix is not None


# --------------------------------------------------------------- model

def _small(name="smol-d128"):
    """The reduced config of a stand-in with the corpus's 256-byte vocab
    and head_dim 64, so that the benchmarks' group of 32 splits a head in
    two as it does in the stand-ins (at the reduced head_dim of 32,
    per_group would be per_token)."""
    kw = dict(vocab_size=256, head_dim=64)
    jcfg = dataclasses.replace(jreduced(jget_config(name)), **kw)
    tcfg = dataclasses.replace(reduced(get_config(name)), **kw)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "rope_theta", "kv_group",
              "tie_embeddings", "ffn_activation", "rotation"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    return jcfg, tcfg


@pytest.fixture(scope="module")
def small():
    """Reference model and params, the port's LM and bridged params,
    bridged rotations (scaled lambda) and eval tokens."""
    jcfg, tcfg = _small()
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jrots = jm.init_rotations(jax.random.PRNGKey(1))
    lam = np.exp(0.3 * np.random.default_rng(9).standard_normal(
        np.asarray(jrots.k.lam).shape)).astype(np.float32)
    jrots = type(jrots)(k=jtf.Rotation(jrots.k.matrix, jnp.asarray(lam),
                                       jrots.k.signs, jrots.k.kind),
                        v=jrots.v)
    model = LM(tcfg, device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    rots = bridge.rotations({s: {f: np.asarray(getattr(getattr(jrots, s), f))
                                 for f in ("matrix", "lam", "signs")}
                             for s in "kv"})
    toks = np.asarray(JDataIterator(JCorpus(100), batch_per_shard=2,
                                    seq_len=48).next()["tokens"])
    return jm, jp, jrots, model, params, rots, toks


def _jppl(jm, jp, toks, rots, cfg):
    logits, _ = jm.forward(jp, jnp.asarray(toks), rots=rots,
                           kv_quant_cfg=cfg, remat=False)
    lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
    nll = -jnp.take_along_axis(lp, jnp.asarray(toks)[:, 1:, None], -1)
    return float(jnp.exp(jnp.mean(nll)))


# relative to max |reference logit|.  Given the same input every block
# agrees with the reference to the bit in 85-100% of its outputs and to
# a bf16 ulp elsewhere (fp32 sums in another order before a bf16 cast);
# over two layers and the tied unembedding that gave 0.0087 without the
# hook.  With the 4-bit hook a one-ulp change of a K/V element can move
# its code by a whole step, so the hooked forward is held to the engine
# tests' 5% (largest measured 0.034, at per_token); hook PPL, the
# quantity the benchmarks report, is held to 1e-3 below (largest
# measured 7.9e-4, per_group).
FWD_TOL = 0.02
HOOK_FWD_TOL = 0.05
GROUP = 32  # the benchmarks' group: two per head at head_dim 64


@pytest.mark.parametrize("cfg", [None, dict(bits=4, scheme="per_token"),
                                 dict(bits=4, scheme="per_channel_group",
                                      group=GROUP),
                                 dict(bits=8, scheme="per_group",
                                      group=GROUP)])
def test_forward_matches_reference(small, cfg):
    jm, jp, jrots, model, params, rots, toks = small
    want, _ = jm.forward(jp, jnp.asarray(toks), rots=jrots,
                         kv_quant_cfg=cfg, remat=False)
    got = model.forward(params, _t(toks).long(), rots=rots, kv_quant_cfg=cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    tol = FWD_TOL if cfg is None or cfg["bits"] == 8 else HOOK_FWD_TOL
    assert err <= tol * np.abs(want).max(), err


def test_collect_kv_matches_reference(small):
    """Raw bf16 K/V per layer (L, B, Hkv, S, d): within FWD_TOL of the
    largest |K|, |V| (the same rounding as the forward)."""
    jm, jp, _, model, params, _, toks = small
    jk, jv = jm.collect_kv(jp, jnp.asarray(toks))
    k, v = model.collect_kv(params, _t(toks).long())
    for got, want in ((k, jk), (v, jv)):
        want = np.asarray(want.astype(jnp.float32))
        assert tuple(got.shape) == want.shape
        err = np.abs(got.float().numpy() - want).max()
        assert err <= FWD_TOL * np.abs(want).max(), err


@pytest.mark.parametrize("scheme", [None] + SCHEMES)
def test_hook_ppl_matches_reference(small, scheme):
    """Teacher-forced PPL through the hook, within 1e-3 relative."""
    jm, jp, jrots, model, params, rots, toks = small
    cfg = None if scheme is None else dict(bits=4, scheme=scheme,
                                           group=GROUP)
    got = bcommon.hook_ppl(model, params, _t(toks).long(), rots, cfg)
    want = _jppl(jm, jp, toks, jrots, cfg)
    assert abs(got - want) <= 1e-3 * want, (got, want)


def test_calibrated_rots_match_reference(small):
    """Static lambda per layer from collect_kv: within 2% (the K/V maxima
    differ by bf16 rounding of the activations; largest measured 0.52%),
    the rotation matrices untouched."""
    jm, jp, jrots, model, params, rots, toks = small
    got = bcommon.calibrated_rots(model, params, _t(toks).long(), rots)
    jk, jv = jm.collect_kv(jp, jnp.asarray(toks))
    for i, (rk, rv) in enumerate(got):
        for rot, jr, act in ((rk, jrots.k, jk), (rv, jrots.v, jv)):
            jri = jax.tree.map(lambda a: a[i], jr)
            want = jcal.static_lambda(jri, act[i])
            np.testing.assert_allclose(rot.lam.numpy(), np.asarray(want),
                                       rtol=2e-2)
            np.testing.assert_array_equal(rot.matrix.numpy(),
                                          np.asarray(jri.matrix))


@pytest.mark.parametrize("alpha,inject_v", [(100.0, False), (64.0, True)])
def test_inject_kv_outliers_matches_reference(small, alpha, inject_v):
    """Bitwise equal to the reference's patch after bridging; the input
    params untouched and every patched tensor a new one.  At alpha = 64
    (a power of two, so every scaled bf16 weight is exact) the forward is
    unchanged within 1e-5 of the largest logit; at other alphas only up
    to the bf16 rounding of the scaled weights."""
    jm, jp, _, model, params, _, toks = small
    hd = model.cfg.head_dim
    before = [t.clone() for t in tree_leaves(params)]
    got = outliers.inject_kv_outliers(params, head_dim=hd, alpha=alpha,
                                      inject_v=inject_v)
    want = bridge.lm_params(jax.tree.map(np.asarray, jout.inject_kv_outliers(
        jp, head_dim=hd, alpha=alpha, inject_v=inject_v)))
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for b, p in zip(before, tree_leaves(params)):
        assert torch.equal(b, p)
    ptrs = [b["attn"][n]["w"].data_ptr() for b in got["blocks"]
            for n in ("wq", "wk", "wv", "wo")]
    old = {t.data_ptr() for t in tree_leaves(params)}
    patched = ptrs if inject_v else ptrs[:2] + ptrs[4:6]
    assert len(set(ptrs)) == len(ptrs) and not old & set(patched)
    if alpha == 64.0:
        tok = _t(toks).long()
        a = model.forward(params, tok)
        b = model.forward(got, tok)
        assert (a - b).abs().max() <= 1e-5 * a.abs().max()
        k0 = model.collect_kv(params, tok)[0][:, ..., 2].float().abs().max()
        k1 = model.collect_kv(got, tok)[0][:, ..., 2].float().abs().max()
        assert torch.isclose(k1, 64.0 * k0)


def test_init_rotations_shape_and_kinds():
    model = LM(_small()[1], device="cpu")
    rots = model.init_rotations(model.generator(0))
    assert len(rots) == model.cfg.n_layers
    for rk, rv in rots:
        d = model.cfg.head_dim
        assert rk.matrix.shape == (d, d) and not torch.equal(rk.signs,
                                                             rv.signs)
        eye = rk.matrix @ rk.matrix.T
        torch.testing.assert_close(eye, torch.eye(d), atol=1e-5, rtol=0)
    off = LM(dataclasses.replace(model.cfg, kv_quant=False), device="cpu")
    assert off.init_rotations(off.generator(0)) is None


# ------------------------------------------------------------- training

def test_corpus_and_iterator_match_reference():
    for shard, step, n in ((0, 0, 300), (5, 17, 1000)):
        np.testing.assert_array_equal(SyntheticCorpus(3).tokens(shard, step,
                                                                n),
                                      JCorpus(3).tokens(shard, step, n))
    it = DataIterator(SyntheticCorpus(1), batch_per_shard=3, seq_len=64,
                      device="cpu")
    jit_ = JDataIterator(JCorpus(1), batch_per_shard=3, seq_len=64)
    for _ in range(2):
        got = it.next()["tokens"]
        assert got.dtype == torch.long and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), jit_.next()["tokens"])
    assert it.step == 2


# gradients of bf16 params are bf16 in both frameworks; each leaf is held
# within this share of its largest |gradient| (bf16 rounding of the
# activations and of the gradients themselves; largest measured 0.015)
GRAD_TOL = 0.06


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_value_and_grad(small, remat):
    jm, jp, _, model, params, _, toks = small
    batch = {"tokens": jnp.asarray(toks)}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(jp)
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = model.loss(p, {"tokens": _t(toks).long()}, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    assert abs(loss.item() - float(jl)) <= 1e-3 * float(jl)
    assert metrics["ce"] is loss
    want = tree_leaves(bridge.lm_params(jax.tree.map(np.asarray, jg)))
    for g, w in zip(grads, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        w = w.float()
        err = (g.float() - w).abs().max()
        assert err <= GRAD_TOL * w.abs().max() + 1e-12, err


def _masked_case(small, family):
    """(reference model, its params, the port's model, bridged params,
    the reference's batch, the port's batch) with a seeded 0/1 loss mask
    whose first row is all zeros; a vlm (reduced llava-next-34b) also
    carries seeded patches."""
    if family == "dense":
        jm, jp, _, model, params, _, toks = small
        patches = None
    else:
        arch = "llava-next-34b"
        jm = build_model(jreduced(jget_config(arch)))
        jp = jm.init(jax.random.PRNGKey(0))
        model = LM(reduced(get_config(arch)), device="cpu")
        params = bridge.lm_params(jax.tree.map(np.asarray, jp))
        rng = np.random.default_rng(27)
        toks = rng.integers(0, model.cfg.vocab_size, (2, 23)).astype(np.int32)
        patches = rng.standard_normal((2, 8, model.cfg.d_model)).astype(
            np.float32)
    mask = np.random.default_rng(26).integers(0, 2, toks.shape).astype(
        np.int32)
    mask[0] = 0
    batch = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    tbatch = {"tokens": _t(toks).long(), "loss_mask": _t(mask)}
    if patches is not None:
        batch["patches"], tbatch["patches"] = jnp.asarray(patches), _t(
            patches)
    return jm, jp, model, params, batch, tbatch


@pytest.mark.parametrize("family", ["dense", "vlm"])
def test_masked_loss_and_grads_match_value_and_grad(small, family):
    """``batch["loss_mask"]`` weights each target's NLL as the reference's
    loss does (a row of zeros included): loss within rtol 1e-3 and every
    leaf's gradient within GRAD_TOL of its largest, as the unmasked test
    above; the loss is not the unmasked one."""
    jm, jp, model, params, batch, tbatch = _masked_case(small, family)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, batch, remat=False), has_aux=True)(jp)
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = model.loss(p, tbatch)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    assert abs(loss.item() - float(jl)) <= 1e-3 * float(jl)
    plain, _ = model.loss(params, {k: v for k, v in tbatch.items()
                                   if k != "loss_mask"})
    assert plain.item() != loss.item()
    want = tree_leaves(bridge.lm_params(jax.tree.map(np.asarray, jg)))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        w = w.float()
        err = (g.float() - w).abs().max()
        assert err <= GRAD_TOL * w.abs().max() + 1e-12, err


def test_all_zero_mask_gives_zero_loss_as_the_reference(small):
    """Every target masked: the reference divides by max(count, 1), so
    the loss is 0 and every gradient 0."""
    jm, jp, _, model, params, _, toks = small
    zeros = np.zeros(toks.shape, np.int32)
    jl, _ = jm.loss(jp, {"tokens": jnp.asarray(toks),
                         "loss_mask": jnp.asarray(zeros)}, remat=False)
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = model.loss(p, {"tokens": _t(toks).long(),
                             "loss_mask": _t(zeros)})
    assert float(jl) == loss.item() == 0.0
    grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)
    assert all(g is None or not g.any() for g in grads)


@pytest.mark.parametrize("step", [0, 5])
def test_adam_update_matches_reference(step):
    """Identical grads, state and params: moments within rtol 1e-6; fp32
    params within rtol 1e-6, bf16 params within one bf16 ulp (the fp32
    update may land on either side of a bf16 rounding boundary)."""
    rng = np.random.default_rng(step)
    params = {"w": rng.standard_normal((8, 16)).astype(np.float32),
              "blocks": [{"s": rng.standard_normal(16).astype(np.float32)}]}
    grads = tree_map(lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(
        np.float32), params)
    mu = tree_map(lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(
        np.float32), params)
    nu = tree_map(lambda a: np.abs(rng.standard_normal(a.shape) * 1e-5)
                  .astype(np.float32), params)
    jparams = {"w": jnp.asarray(params["w"], jnp.bfloat16),
               "blocks": [{"s": jnp.asarray(params["blocks"][0]["s"])}]}
    jstate = jadam.AdamState(jnp.asarray(step, jnp.int32),
                             jax.tree.map(jnp.asarray, mu),
                             jax.tree.map(jnp.asarray, nu))
    jnew, jst = jadam.adam_update(jax.tree.map(jnp.asarray, grads), jstate,
                                  jparams, lr=3e-3, weight_decay=0.01)
    tparams = {"w": bridge.to_torch(np.asarray(jparams["w"])),
               "blocks": [{"s": _t(params["blocks"][0]["s"])}]}
    state = adam.AdamState(torch.tensor(step, dtype=torch.int32),
                           tree_map(_t, mu), tree_map(_t, nu))
    new, st = adam.adam_update(tree_map(_t, grads), state, tparams, lr=3e-3,
                               weight_decay=0.01)
    assert int(st.step) == int(jst.step) == step + 1
    for a, b in ((st.mu, jst.mu), (st.nu, jst.nu)):
        for x, y in ((a["w"], b["w"]), (a["blocks"][0]["s"],
                                         b["blocks"][0]["s"])):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
    assert new["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(new["w"].float().numpy(),
                               np.asarray(jnew["w"].astype(jnp.float32)),
                               rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(new["blocks"][0]["s"].numpy(),
                               np.asarray(jnew["blocks"][0]["s"]), rtol=1e-6)


def test_clip_and_cosine_schedule_match_reference():
    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((5, 7)).astype(np.float32),
         "b": [rng.standard_normal(3).astype(np.float32)]}
    got, gn = adam.clip_by_global_norm(tree_map(_t, g), 0.5)
    want, jgn = jadam.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for x, y in ((got["a"], want["a"]), (got["b"][0], want["b"][0])):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
    lr, jlr = adam.cosine_schedule(1e-3, 10, 100), jadam.cosine_schedule(
        1e-3, 10, 100)
    for s in (0, 3, 10, 55, 100, 130):
        np.testing.assert_allclose(
            float(lr(torch.tensor(s, dtype=torch.int32))),
            float(jlr(jnp.asarray(s, jnp.int32))), rtol=1e-6)


def test_train_steps_track_reference_losses():
    """Ten AdamW steps from the same params on the same batches: the loss
    within 1% of the reference's at every step (params are not compared:
    Adam's first step moves a near-zero gradient element by about +-lr,
    and its sign may differ between frameworks)."""
    jcfg, tcfg = _small("smol-d64")
    jm = build_model(jcfg)
    jp, jopt = jsteps.init_train_state(jm, jax.random.PRNGKey(0))
    jstep = jax.jit(jsteps.make_train_step(jm, lr=3e-3))
    model = LM(tcfg, device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    opt = adam.adam_init(params)
    step = make_train_step(model, lr=3e-3)
    jit_ = JDataIterator(JCorpus(0), batch_per_shard=4, seq_len=32)
    it = DataIterator(SyntheticCorpus(0), batch_per_shard=4, seq_len=32,
                      device="cpu")
    got, want = [], []
    for _ in range(10):
        jp, jopt, jmet = jstep(jp, jopt, jit_.next())
        params, opt, met = step(params, opt, it.next())
        want.append(float(jmet["loss"]))
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert got[-1] < got[0] and int(opt.step) == 10
    assert not any(t.requires_grad for t in tree_leaves(params))


def test_kernel_quality_runs_end_to_end_on_cpu(tmp_path):
    """The whole benchmark at a tiny size (a reduced stand-in, 3 steps,
    64 rows): every row and claim present, the kernel checks true (the
    plain versions against themselves on the CPU), the ladder finite."""
    cfg = _small()[1]
    rec = kernel_quality.run(quick=True, device="cpu", name=cfg, steps=3,
                             n=64, out_dir=tmp_path)
    assert len(rec["bit_exactness"]) == 12
    assert all(kernel_quality.kernel_claims(rec["bit_exactness"]).values())
    assert {"scaled_g32_best", "reduction_over_per_token_large",
            "int4_bit_exact"} <= set(rec["claims"])
    ladder = rec["quality_ladder"]
    assert [r["kernel_variant"] for r in ladder["rows"]] == [
        "per_token", "g32_no_lambda", "scaled_g32"]
    assert all(np.isfinite(r["dppl"]) for r in ladder["rows"])
    assert rec["standin"]["steps"] == 3 and rec["device"] == "cpu"
    assert (tmp_path / "kernel_quality.json").exists()
