"""The bridge carries a JAX ``LM.init`` parameter tree and a cache's
rotations into the port bit-for-bit (bf16 leaves included)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_params_and_rotations_round_trip_bit_exact():
    cfg = reduced(get_config("internlm2-1.8b"))
    jm = build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.lm_params(jax.tree.map(np.asarray, jp))

    leaves = jax.tree_util.tree_leaves_with_path(jp)
    n_checked = 0
    for path, leaf in leaves:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i in range(cfg.n_layers):
                t = tp["blocks"][i]
                for k in keys[1:]:
                    t = t[k]
                assert t.dtype == (torch.bfloat16 if leaf.dtype.name ==
                                   "bfloat16" else t.dtype)
                np.testing.assert_array_equal(_bits(t),
                                              _ref_bits(leaf)[i])
                n_checked += 1
        else:
            t = tp
            for k in keys:
                t = t[k]
            np.testing.assert_array_equal(_bits(t), _ref_bits(leaf))
            n_checked += 1
    assert n_checked > 20
    assert tp["blocks"][0]["attn"]["wq"]["w"].dtype == torch.bfloat16

    cache = jm.init_cache(1, 32, policy="int4-srft",
                          key=jax.random.PRNGKey(3))
    data = cache["attn"].data
    tree = {side: {f: np.asarray(getattr(getattr(data, f"rot_{side}"), f))
                   for f in ("matrix", "lam", "signs")}
            for side in ("k", "v")}
    rots = bridge.rotations(tree)
    assert len(rots) == cfg.n_layers
    for i, (rk, rv) in enumerate(rots):
        for side, r in (("k", rk), ("v", rv)):
            for f in ("matrix", "lam", "signs"):
                np.testing.assert_array_equal(getattr(r, f).numpy(),
                                              tree[side][f][i])
