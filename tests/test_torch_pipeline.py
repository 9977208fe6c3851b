"""The GPipe forward (``repro_torch.distributed.pipeline``): the port's
single-controller schedule against its own sequential loop, bit for bit,
and against the reference's ``pipeline_forward`` (a ``shard_map`` over 4
simulated devices, run in a subprocess with
``--xla_force_host_platform_device_count=4`` as
``tests/test_distributed.py`` runs it), within that test's atol 1e-5."""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import textwrap  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.distributed.pipeline import pipeline_forward  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_LAYERS, D = 8, 16


def _layer(w, x):
    return torch.tanh(x @ w)


def _weights():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((N_LAYERS, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((4, 2, D)).astype(np.float32)
    return ws, x


def _sequential(layer_fn, layers, x):
    """Each microbatch through every layer in order."""
    out = torch.empty_like(x)
    for mb in range(x.shape[0]):
        h = x[mb]
        for p in layers:
            h = layer_fn(p, h)
        out[mb] = h
    return out


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8])
def test_pipeline_equals_the_sequential_loop(n_stages):
    ws, x = _weights()
    ws, x = torch.from_numpy(ws), torch.from_numpy(x)
    mesh = make_mesh((n_stages,), ("pod",), devices=["cpu"] * n_stages)
    out = pipeline_forward(_layer, ws, x, mesh=mesh, axis="pod",
                           n_layers=N_LAYERS)
    assert torch.equal(out, _sequential(_layer, list(ws), x))


def test_pipeline_over_model_blocks():
    """A reduced internlm2's blocks (the port's per-layer list) in 2
    stages equal the blocks run in order, microbatch by microbatch."""
    model = LM(reduced(get_config("internlm2-1.8b")), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    blocks = params["blocks"]
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 1, 8, model.cfg.d_model), generator=g).to(
        torch.bfloat16)

    def layer_fn(p, h):  # one full-sequence block, no cache
        return model._block_full(p, h)[0]

    mesh = make_mesh((2,), ("pod",), devices=["cpu"] * 2)
    out = pipeline_forward(layer_fn, blocks, x, mesh=mesh, axis="pod",
                           n_layers=len(blocks))
    assert torch.equal(out, _sequential(layer_fn, blocks, x))


def test_pipeline_refuses_an_uneven_split():
    ws, x = _weights()
    mesh = make_mesh((3,), ("pod",), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="stages"):
        pipeline_forward(_layer, torch.from_numpy(ws), torch.from_numpy(x),
                         mesh=mesh, n_layers=N_LAYERS)


def test_pipeline_matches_the_reference(tmp_path):
    """The reference's shard_map pipeline on 4 simulated devices and the
    port's on a 4-stage mesh of the CPU agree within atol 1e-5."""
    ws, x = _weights()
    np.save(tmp_path / "ws.npy", ws)
    np.save(tmp_path / "x.npy", x)
    script = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.distributed.pipeline import pipeline_forward
        ws = jnp.asarray(np.load({str(tmp_path / 'ws.npy')!r}))
        x = jnp.asarray(np.load({str(tmp_path / 'x.npy')!r}))
        mesh = jax.make_mesh((4,), ("pod",))
        out = pipeline_forward(lambda w, h: jnp.tanh(h @ w), ws, x,
                               mesh=mesh, axis="pod", n_layers={N_LAYERS})
        np.save({str(tmp_path / 'out.npy')!r}, np.asarray(out))
        print("ok")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = np.load(tmp_path / "out.npy")
    mesh = make_mesh((4,), ("pod",), devices=["cpu"] * 4)
    got = pipeline_forward(_layer, torch.from_numpy(ws), torch.from_numpy(x),
                           mesh=mesh, axis="pod", n_layers=N_LAYERS)
    assert ref.shape == tuple(got.shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
