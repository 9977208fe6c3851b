"""Port parity, core modules: packing, per-group quantization and the
rotations of ``repro_torch.core`` against ``repro.core`` on the same
numpy inputs (CPU)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import packing as jpacking  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import transforms as jtf  # noqa: E402
from repro_torch.core import packing, quant, transforms  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 128), (7, 112)])
def test_pack_unpack_bit_exact(shape):
    codes = np.random.default_rng(0).integers(-8, 8, shape).astype(np.int8)
    packed = packing.pack_int4(_t(codes)).numpy()
    np.testing.assert_array_equal(
        packed, np.asarray(jpacking.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(packing.unpack_int4(_t(packed)).numpy(),
                                  codes)


@pytest.mark.parametrize("bits,group", [(4, 32), (4, 16), (8, 32), (4, 28)])
def test_quantize_per_group_bit_exact(bits, group):
    d = 112 if group == 28 else 128
    x = np.random.default_rng(bits + group).standard_normal(
        (6, 9, d)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero group takes the 1e-12 floor
    got = quant.quantize_per_group(_t(x), bits, group)
    ref = jquant.quantize_per_group(jnp.asarray(x), bits, group)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
    np.testing.assert_array_equal(
        quant.dequantize_per_group(got, group).numpy(),
        np.asarray(jquant.dequantize_per_group(ref, group)))


@pytest.mark.parametrize("kind", ["srft", "srht", "identity"])
@pytest.mark.parametrize("d", [64, 128])
def test_transform_matrix_and_rotation_match(kind, d):
    """fp32 within 1e-6: both sides build B from an FFT / Hadamard of the
    identity, in different libraries."""
    jrot = jtf.make_rotation(kind, jax.random.PRNGKey(d), d)
    lam = np.exp(0.3 * np.random.default_rng(d).standard_normal(d)).astype(
        np.float32)
    signs = np.asarray(jrot.signs)
    mat = transforms.transform_matrix(kind, _t(signs))
    np.testing.assert_allclose(mat.numpy(), np.asarray(jrot.matrix), atol=1e-6)
    jrot = jtf.Rotation(jrot.matrix, jnp.asarray(lam), jrot.signs, kind)
    rot = transforms.Rotation(mat, _t(lam), _t(signs), kind)
    x = np.random.default_rng(1).standard_normal((4, 3, d)).astype(np.float32)
    y = rot.forward(_t(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jrot.forward(x)),
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(rot.inverse(y).numpy(), x, atol=1e-5)
    np.testing.assert_allclose(
        rot.folded_query_matrix().numpy(),
        np.asarray(jrot.folded_query_matrix()), rtol=1e-6, atol=1e-7)


def test_srft_forward_matches_and_is_orthonormal():
    d = 128
    signs = np.where(np.random.default_rng(3).random(d) < 0.5, 1.0,
                     -1.0).astype(np.float32)
    x = np.random.default_rng(4).standard_normal((10, d)).astype(np.float32)
    got = transforms.srft_forward(_t(x), _t(signs)).numpy()
    ref = np.asarray(jtf.srft_forward(jnp.asarray(x), jnp.asarray(signs)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1),
                               np.linalg.norm(x, axis=-1), rtol=1e-5)


def test_make_rotation_is_seeded_and_orthonormal():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    r1 = transforms.make_rotation("srft", g1, 64)
    r2 = transforms.make_rotation("srft", g2, 64)
    assert torch.equal(r1.matrix, r2.matrix)
    eye = r1.matrix @ r1.matrix.T
    np.testing.assert_allclose(eye.numpy(), np.eye(64), atol=1e-5)
