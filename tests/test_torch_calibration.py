"""Port parity for the learned-rotation calibration (paper §5), on the CPU:
the Cayley and Householder matrices, ``compose_rotation``,
``reconstruction_mse``, its straight-through gradient, and ``calibrate``
against ``repro.core.calibrate``.  Inputs are the reference tests'
outlier activations (d = 32, channel 2 scaled by 20), made with numpy
from a seed; the reference's ``CalibParams`` and base rotations cross
through ``repro_torch.bridge``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import calibrate as jcal  # noqa: E402
from repro.core import transforms as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import calibrate as C  # noqa: E402

D = 32
MAT_ATOL = 1e-5  # Cayley / Householder / composed matrices and lambda
MSE_RTOL = 1e-5
# the gradient: fp32 sums in another order on each side (and the
# Householder product in another association)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
TIE_BAND = 1e-4  # a code this close to a .5 tie may round either way
# whole-run MSE reduction, port vs reference on the same activations: the
# batches come from different generators (JAX keys, a torch.Generator),
# so the runs differ; three port seeds spread up to 0.018 around the
# reference at 60 steps
REDUCTION_BAND = 0.05

VARIANTS = {
    "lambda": dict(learn_lambda=True),
    "cayley": dict(learn_lambda=True, learn_cayley=True),
    "householder": dict(learn_lambda=True, learn_householder=D // 2),
    "all": dict(learn_lambda=True, learn_cayley=True,
                learn_householder=D // 2),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _activations(seed, n=2048, outlier=True):
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    if outlier:
        x[:, 2] *= 20.0  # per-channel outlier (paper §5.6)
    return x


def _base(kind="srft", seed=2):
    jb = jtf.make_rotation(kind, jax.random.PRNGKey(seed), D)
    tb = bridge.rotation({"matrix": np.asarray(jb.matrix),
                          "lam": np.asarray(jb.lam),
                          "signs": np.asarray(jb.signs)}, kind)
    return jb, tb


def _params(kw, seed=5):
    """Reference CalibParams moved away from the identity (as the
    reference's orthogonality test does), as numpy leaves."""
    rng = np.random.default_rng(seed)
    p = jcal.init_calib_params(D, key=jax.random.PRNGKey(seed), **kw)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return jcal.CalibParams(
        None if p.log_lam is None else f32(0.3 * rng.standard_normal(D)),
        None if p.cayley_u is None else f32(0.3 * rng.standard_normal((D, D))),
        None if p.householder_v is None
        else f32(rng.standard_normal(p.householder_v.shape)))


def _jparams(p):
    return jcal.CalibParams(*(None if a is None else jnp.asarray(a)
                              for a in p))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_matrices_and_compose_match_reference(variant):
    p = _params(VARIANTS[variant])
    tp = bridge.calib_params(p)
    if p.cayley_u is not None:
        np.testing.assert_allclose(
            C._cayley_matrix(tp.cayley_u).numpy(),
            np.asarray(jcal._cayley_matrix(jnp.asarray(p.cayley_u))),
            atol=MAT_ATOL)
    if p.householder_v is not None:
        np.testing.assert_allclose(
            C._householder_matrix(tp.householder_v).numpy(),
            np.asarray(jcal._householder_matrix(
                jnp.asarray(p.householder_v))), atol=MAT_ATOL)
    jb, tb = _base()
    jr = jcal.compose_rotation(jb, _jparams(p))
    tr = C.compose_rotation(tb, tp)
    np.testing.assert_allclose(tr.matrix.numpy(), np.asarray(jr.matrix),
                               atol=MAT_ATOL)
    np.testing.assert_allclose(tr.lam.numpy(), np.asarray(jr.lam),
                               rtol=MAT_ATOL)
    eye = (tr.matrix @ tr.matrix.T).numpy()
    np.testing.assert_allclose(eye, np.eye(D), atol=1e-4)


def test_householder_odd_count_and_single_reflector():
    """The tree product carries an odd reflector: k = 1, 3, 5 against the
    reference's scan."""
    rng = np.random.default_rng(9)
    for k in (1, 3, 5):
        v = rng.standard_normal((k, D)).astype(np.float32)
        np.testing.assert_allclose(
            C._householder_matrix(torch.from_numpy(v)).numpy(),
            np.asarray(jcal._householder_matrix(jnp.asarray(v))),
            atol=MAT_ATOL)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group", [None, 32, 8])
def test_reconstruction_mse_matches_reference(bits, group):
    x = _activations(1)
    p = _params(VARIANTS["all"])
    jb, tb = _base()
    jr = jcal.compose_rotation(jb, _jparams(p))
    tr = C.compose_rotation(tb, bridge.calib_params(p))
    want = float(jcal.reconstruction_mse(jr, jnp.asarray(x), bits=bits,
                                         group=group))
    got = float(C.reconstruction_mse(tr, torch.from_numpy(x), bits=bits,
                                     group=group))
    np.testing.assert_allclose(got, want, rtol=MSE_RTOL)


def _off_tie_rows(rot, x, bits, group):
    """Rows of ``x`` where no code's y/scale lies within TIE_BAND of a .5
    tie (float64): there both frameworks round alike."""
    g = group or D
    y = (torch.from_numpy(x).double() @ rot.matrix.double().T
         * rot.lam.double())
    yg = y.reshape(len(x), D // g, g)
    m = 2 ** (bits - 1) - 1
    u = yg / (yg.abs().amax(-1, keepdim=True).clamp_min(1e-12) / m)
    near = ((u.abs() % 1.0) - 0.5).abs() < TIE_BAND
    return ~near.reshape(len(x), -1).any(-1)


@pytest.mark.parametrize("variant", ["lambda", "cayley", "householder",
                                     "all"])
@pytest.mark.parametrize("group", [None, 32])
def test_ste_gradient_matches_reference(variant, group):
    """d loss / d (active params) on one batch: port autograd against
    ``jax.value_and_grad`` of the reference's own compose + MSE.  Rows
    holding a code within TIE_BAND of a .5 tie are dropped from the batch
    on both sides (a tie may round either way across frameworks, which
    moves the loss and the scale's gradient); at least 90% stay."""
    bits = 4
    x = _activations(3, n=1024)
    p = _params(VARIANTS[variant], seed=11)
    jb, tb = _base()
    tp = bridge.calib_params(p)
    keep = _off_tie_rows(C.compose_rotation(tb, tp), x, bits, group)
    assert keep.float().mean() > 0.9
    xb = x[keep.numpy()]
    active = {f: getattr(p, f) for f in p._fields
              if getattr(p, f) is not None}

    def jloss(act):
        rot = jcal.compose_rotation(jb, jcal.CalibParams(
            act.get("log_lam"), act.get("cayley_u"),
            act.get("householder_v")))
        return jcal.reconstruction_mse(rot, jnp.asarray(xb), bits=bits,
                                       group=group)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        {k: jnp.asarray(v) for k, v in active.items()})
    act = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in active.items()}
    tl = C.reconstruction_mse(C.compose_rotation(tb, C.CalibParams(
        act.get("log_lam"), act.get("cayley_u"), act.get("householder_v"))),
        torch.from_numpy(xb), bits=bits, group=group)
    tg = dict(zip(act, torch.autograd.grad(tl, list(act.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=MSE_RTOL)
    for k in active:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(
            tg[k].numpy(), want, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(1.0, np.abs(want).max()), err_msg=k)
        assert np.abs(want).max() > 0, f"{k}: zero gradient"


@pytest.mark.parametrize("variant", ["lambda", "cayley", "householder"])
def test_calibration_reduces_mse(variant):
    """The reference's test_calibration_reduces_mse on the port."""
    _, tb = _base()
    x = torch.from_numpy(_activations(3))
    _, diag = C.calibrate(tb, x, bits=4, steps=60, lr=1e-2,
                          **VARIANTS[variant])
    assert diag["mse_final"] < diag["mse_initial"], diag
    assert diag["mse_reduction"] > 0.05, diag


@pytest.mark.parametrize("variant", ["cayley", "householder"])
def test_learned_rotation_stays_orthogonal(variant):
    _, tb = _base(seed=4)
    g = torch.Generator().manual_seed(6)
    p = C.init_calib_params(
        D, learn_lambda=False, learn_cayley=variant == "cayley",
        learn_householder=D // 2 if variant == "householder" else 0,
        generator=torch.Generator().manual_seed(5))
    if variant == "cayley":
        p = p._replace(cayley_u=torch.randn((D, D), generator=g) * 0.3)
    else:
        p = p._replace(householder_v=torch.randn((D // 2, D), generator=g))
    rot = C.compose_rotation(tb, p)
    np.testing.assert_allclose((rot.matrix @ rot.matrix.T).numpy(),
                               np.eye(D), atol=1e-4)


def test_init_is_near_identity_and_householder_is_half_of_cayley():
    """Paper Table 3: Householder k=d/2 stores (d/2)*d vs Cayley d^2; the
    init is the reference's (zeros, 1e-3 noise, the first k rows of I)."""
    p_c = C.init_calib_params(D, learn_lambda=True, learn_cayley=True)
    p_h = C.init_calib_params(D, learn_lambda=False,
                              learn_householder=D // 2)
    assert p_h.householder_v.numel() * 2 == p_c.cayley_u.numel()
    assert p_h.log_lam is None and p_c.householder_v is None
    assert torch.equal(p_c.log_lam, torch.zeros(D))
    assert 0 < p_c.cayley_u.abs().max() < 1e-2
    dev = (p_h.householder_v - torch.eye(D)[: D // 2]).abs().max()
    assert 0 < dev < 1e-2


def test_no_srft_base_can_reach_lower_mse():
    """Paper §5.3 setup: identity base + learned R is free to overfit MSE."""
    _, tb = _base("identity", seed=7)
    _, diag = C.calibrate(tb, torch.from_numpy(_activations(8)), bits=4,
                          steps=80, lr=1e-2, learn_lambda=True,
                          learn_cayley=True)
    assert diag["mse_reduction"] > 0.3, diag


@pytest.mark.parametrize("variant,kind", [("lambda", "srft"),
                                          ("householder", "srft"),
                                          ("cayley", "identity")])
def test_whole_run_reduction_matches_reference(variant, kind):
    """The same activations and base through both ``calibrate``s (60
    steps, lr 1e-2): the same initial MSE, and final reductions within
    REDUCTION_BAND (different batch draws)."""
    jb, tb = _base(kind, seed=2)
    x = _activations(3)
    kw = VARIANTS[variant]
    _, dj = jcal.calibrate(jb, jnp.asarray(x), bits=4, steps=60, lr=1e-2,
                           **kw)
    rot, dt = C.calibrate(tb, torch.from_numpy(x), bits=4, steps=60,
                          lr=1e-2, generator=torch.Generator().manual_seed(0),
                          **kw)
    if variant == "lambda":  # no noise in the init: the same start
        np.testing.assert_allclose(dt["mse_initial"], dj["mse_initial"],
                                   rtol=MSE_RTOL)
    else:  # 1e-3 noise drawn by each generator
        np.testing.assert_allclose(dt["mse_initial"], dj["mse_initial"],
                                   rtol=2e-2)
    assert abs(dt["mse_reduction"] - dj["mse_reduction"]) < REDUCTION_BAND, \
        (dt, dj)
    assert torch.isfinite(rot.lam).all() and (rot.lam > 0).all()


def test_calibrate_is_a_function_of_its_generator():
    """Two runs from equal generators are equal; the batches and the init
    come from the caller's generator only."""
    _, tb = _base()
    x = torch.from_numpy(_activations(3, n=512))
    runs = [C.calibrate(tb, x, steps=10, lr=1e-2, learn_cayley=True,
                        generator=torch.Generator().manual_seed(s))
            for s in (4, 4, 5)]
    assert torch.equal(runs[0][0].matrix, runs[1][0].matrix)
    assert runs[0][1] == runs[1][1]
    assert not torch.equal(runs[0][0].matrix, runs[2][0].matrix)
