"""Port parity, the inverse transforms and the packing size: the port's
``hermitian_unpack``, ``srft_inverse``, ``srht_inverse`` and
``packed_nbytes`` against ``repro.core``'s on the same numpy inputs (CPU),
and each inverse undoing its forward."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpacking  # noqa: E402
from repro.core import transforms as jtf  # noqa: E402
from repro_torch.core import packing, transforms  # noqa: E402

DIMS = (64, 112, 128, 256)
# the reference's calls are jitted: eager, each of its ops compiles alone
ROUND_TRIP_TOL = 1e-5
REF_TOL = 1e-5  # two FFT libraries: fp32 rounding, no more


def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    signs = np.where(rng.random(d) < 0.5, 1.0, -1.0).astype(np.float32)
    return x, signs


@pytest.mark.parametrize("d", DIMS)
def test_hermitian_unpack_matches_the_reference(d):
    x, _ = _inputs(d, d)
    got = transforms.hermitian_unpack(torch.from_numpy(x), d)
    want = np.asarray(jax.jit(jtf.hermitian_unpack, static_argnums=1)(
        jnp.asarray(x), d))
    assert got.shape == want.shape == (3, 5, d // 2 + 1)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REF_TOL)
    # unpack inverts pack
    packed = transforms.hermitian_pack(got, d)
    np.testing.assert_allclose(packed.numpy(), x, rtol=0,
                               atol=ROUND_TRIP_TOL)


@pytest.mark.parametrize("d", DIMS)
def test_srft_inverse_matches_the_reference_and_undoes_the_forward(d):
    x, signs = _inputs(d, d + 1)
    xt, st = torch.from_numpy(x), torch.from_numpy(signs)
    got = transforms.srft_inverse(xt, st)
    want = np.asarray(jax.jit(jtf.srft_inverse)(jnp.asarray(x),
                                                jnp.asarray(signs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REF_TOL)
    back = transforms.srft_inverse(transforms.srft_forward(xt, st), st)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=ROUND_TRIP_TOL)


@pytest.mark.parametrize("d", DIMS)
def test_srht_inverse_matches_the_reference_and_undoes_the_forward(d):
    """d = 112 is no power of two: both packages refuse it alike."""
    x, signs = _inputs(d, d + 2)
    xt, st = torch.from_numpy(x), torch.from_numpy(signs)
    if d & (d - 1):
        with pytest.raises(ValueError, match="power-of-two"):
            transforms.srht_inverse(xt, st)
        with pytest.raises(ValueError, match="power-of-two"):
            jtf.srht_inverse(jnp.asarray(x), jnp.asarray(signs))
        return
    got = transforms.srht_inverse(xt, st)
    want = np.asarray(jax.jit(jtf.srht_inverse)(jnp.asarray(x),
                                                jnp.asarray(signs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REF_TOL)
    back = transforms.srht_inverse(transforms.srht_forward(xt, st), st)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=ROUND_TRIP_TOL)


@pytest.mark.parametrize("d", DIMS)
def test_packed_nbytes_matches_the_reference(d):
    for bits in (4, 8):
        assert packing.packed_nbytes(d, bits) == jpacking.packed_nbytes(
            d, bits)
    for bits in (2, 3, 16):
        with pytest.raises(ValueError, match="4/8-bit"):
            packing.packed_nbytes(d, bits)
        with pytest.raises(ValueError):
            jpacking.packed_nbytes(d, bits)
