"""The port's int8 error-feedback gradient compression
(``repro_torch.distributed.compression``) against the reference's
(``repro.distributed.compression``), on the CPU.

``compress_decompress`` is plain jnp in the reference, with no mesh: the
port's codes equal its codes exactly and its values and residuals lie
within 1e-6 relative.  The reference's ``compressed_psum`` runs only
inside ``shard_map`` (its own test is red in JAX on this tree), so the
port's single-controller ``compressed_psum`` over 8 participants is held
to the sum of the reference's per-participant ``compress_decompress``
outputs, and to the reference test's claim: within 1e-2 relative of the
exact sum of its input, 8 x 512 draws of N(0, 1).  Inputs come from numpy
seeds."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import compression as jc  # noqa: E402
from repro_torch.distributed import compression as tc  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

VALUE_RTOL = 1e-6  # fp32 values: the same operations, one rounding apart


def _draw(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got: torch.Tensor, want, rtol=VALUE_RTOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("shape", [(8, 512), (3, 100), (257,), (2, 3, 64)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_blocks_codes_equal_the_reference(shape, bits):
    """Block abs-max scales and round-half-to-even codes, padded to whole
    blocks of 256: codes equal, scales within 1e-6; a block of zeros
    takes the 1e-12 floor."""
    x = _draw(1, shape, 3.0)
    x.reshape(-1)[:min(x.size, 256)] = 0.0  # a block (or its start) of zeros
    codes, scale, n = tc._quantize_blocks(torch.from_numpy(x), bits)
    jcodes, jscale, jn = jc._quantize_blocks(jnp.asarray(x), bits)
    assert n == jn == x.size
    assert torch.equal(codes, torch.from_numpy(np.array(jcodes)))
    _close(scale, jscale)
    assert codes.abs().max() <= 2 ** (bits - 1) - 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_decompress_and_residual_track_the_reference(dtype):
    """Three chained steps of the local round trip with error feedback:
    x_hat and the residual within 1e-6 relative of the reference's at
    every step, x_hat in the input's dtype."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x0 = torch.from_numpy(_draw(2, (4, 300)))
    st, jst = tc.ef_init(x0.to(tdt)), jc.ef_init(jnp.asarray(x0.numpy(),
                                                             jdt))
    for step in range(3):
        xs = _draw(10 + step, (4, 300))
        x, jx = torch.from_numpy(xs).to(tdt), jnp.asarray(xs).astype(jdt)
        out, st = tc.compress_decompress(x, st)
        jout, jst = jc.compress_decompress(jx, jst)
        assert out.dtype == tdt and st.residual.dtype == torch.float32
        _close(out.float(), np.asarray(jout.astype(jnp.float32)))
        _close(st.residual, jst.residual)


def test_compressed_psum_over_eight_participants():
    """The reference test's input on a simulated ("pod",) mesh of 8 CPU
    devices: every participant's copy of the sum equals the sum of the
    reference's per-participant ``compress_decompress`` outputs within
    fp32 rounding and lies within 1e-2 relative of the exact sum; each
    new state is that participant's residual in the reference."""
    mesh = make_mesh((8,), ("pod",), devices=["cpu"] * 8)
    x = _draw(0, (8, 512))
    devs = mesh.devices_along("pod")
    xs = [torch.from_numpy(x[i]).to(d) for i, d in enumerate(devs)]
    states = [tc.ef_init(t) for t in xs]
    outs, new = tc.compressed_psum(xs, states, bits=8)
    parts = [jc.compress_decompress(jnp.asarray(x[i]), jc.ef_init(
        jnp.asarray(x[i]))) for i in range(8)]
    want = np.sum([np.asarray(p[0]) for p in parts], axis=0)
    exact = x.sum(0)
    for i, (o, d) in enumerate(zip(outs, devs)):
        assert o.device == d and o.dtype == torch.float32
        assert torch.equal(o, outs[0])
        _close(new[i].residual, parts[i][1].residual)
    _close(outs[0], want, rtol=1e-5)
    rel = np.linalg.norm(outs[0].numpy() - exact) / np.linalg.norm(exact)
    assert rel < 1e-2, rel


def test_error_feedback_bounds_the_running_sum():
    """20 steps over 4 participants: the running sum of the outputs stays
    within one step's quantization error of the running sum of the inputs
    (the telescoped residuals: at most half a quantization step a
    participant), where compressing without feedback drifts further."""
    n, shape = 4, (2, 384)
    states = [tc.ef_init(torch.zeros(shape)) for _ in range(n)]
    got = torch.zeros(shape)
    got_nofb = torch.zeros(shape)
    want = np.zeros(shape, np.float32)
    half_steps = []
    for step in range(20):
        xs = [torch.from_numpy(_draw(100 * step + i, shape, 1e-3))
              for i in range(n)]
        half_steps = [float((x + s.residual).abs().max()) / 127 / 2
                      for x, s in zip(xs, states)]
        outs, states = tc.compressed_psum(xs, states)
        fresh = [tc.ef_init(x) for x in xs]
        got += outs[0]
        got_nofb += tc.compressed_psum(xs, fresh)[0][0]
        want += np.sum([x.numpy() for x in xs], axis=0)
    drift = np.abs(got.numpy() - want).max()
    assert drift <= sum(half_steps) * (1 + 1e-3), (drift, sum(half_steps))
    # the telescoped identity, up to the fp32 rounding of 20 sums of n
    residual = torch.stack([s.residual for s in states]).sum(0).numpy()
    slack = 20 * n * 2 ** -23 * np.abs(want).max()
    assert np.abs(got.numpy() - want + residual).max() <= slack
    assert np.abs(got_nofb.numpy() - want).max() > drift


def test_compressed_psum_refuses_mismatched_participants():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="per participant"):
        tc.compressed_psum([x, x], [tc.ef_init(x)])
