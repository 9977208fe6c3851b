"""The plain reference against the port at a reduced size: with the
port's activations in float32 the two differ by rounding alone, and a
reference that forgets the int4 cache differs by far more."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tinycell  # noqa: E402

import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.reference import model as model_mod  # noqa: E402
from perfbench.reference.model import (Reference, hyper_from_config,  # noqa: E402
                                       quantize_rows, srft_matrix)
from repro_torch.core.transforms import transform_matrix  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402


def _cj(**kw):
    cj = json.loads((tinycell.ROOT / "perfbench/configs/qwen3-14b.json")
                    .read_text())
    cj.update(tinycell.TINY)
    cj.update(kw)
    return cj


def test_srft_matrix_is_the_ports_transform():
    g = torch.Generator().manual_seed(0)
    s = torch.where(torch.rand(128, generator=g) < 0.5, 1.0, -1.0)
    b = srft_matrix(s)
    assert torch.allclose(b, transform_matrix("srft", s), atol=1e-6)
    assert torch.allclose(b @ b.T, torch.eye(128), atol=1e-5)


def test_quantize_rows_keeps_int4_codes_per_group():
    x = torch.randn(5, 3, 64, generator=torch.Generator().manual_seed(1))
    b = torch.eye(64)
    q = quantize_rows(x, b).reshape(5, 3, 2, 32)
    scale = x.reshape(5, 3, 2, 32).abs().amax(-1, keepdim=True) / 7
    codes = q / scale
    assert torch.allclose(codes, codes.round(), atol=1e-4)
    assert codes.abs().max() <= 7 + 1e-4


def _port_logits(cfg, params, signs, prompt, served):
    """Prefill then decode the served tokens on a ragged cache through the
    KERNEL backend (its plain version on the CPU)."""
    model = LM(cfg, device="cpu")
    cache = model.init_cache(1, 256, policy="int4-srft", ragged=True,
                             rots=harness._rotations(signs))
    logits, cache = model.prefill(params, torch.as_tensor(prompt)[None],
                                  cache)
    out = [logits[0, -1]]
    for t in served[:-1]:
        logits, cache = model.decode_step(
            params, torch.tensor([[t]]), cache, backend="kernel")
        out.append(logits[0, -1])
    return torch.stack(out)


@pytest.mark.parametrize("qk_norm, n_prompt", [(False, 40), (True, 48)])
def test_reference_logits_match_the_port_in_fp32(qk_norm, n_prompt,
                                                 monkeypatch):
    cj = _cj(qk_norm=qk_norm)
    cfg = harness.model_config(cj)
    params, signs = harness.make_weights(cfg, 11, "cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, n_prompt)
    served = rng.integers(0, cfg.vocab_size, 40).tolist()
    with tinycell.fp32_compute():
        port = _port_logits(cfg, params, signs, prompt, served)
    toks = torch.as_tensor(np.concatenate([prompt, served[:-1]]))
    ref = Reference(hyper_from_config(cj), params, signs)
    want = ref.logits(toks, n_prompt)
    # the same model with an exact cache
    monkeypatch.setattr(model_mod, "quantize_rows", lambda x, b: x)
    exact = ref.logits(toks, n_prompt)
    err = (port - want).abs().max().item()
    err_exact = (port - exact).abs().max().item()
    scale = want.abs().max().item()
    assert err <= 2e-4 * scale, (err, scale)
    assert err_exact >= 10 * err, (err_exact, err)


@pytest.mark.parametrize("workload", ["tiny-closed", "tiny-open"])
def test_served_streams_agree_with_the_reference_in_fp32(tmp_path,
                                                         workload):
    root = tinycell.make_copy(tmp_path, limit=1e-3)
    with tinycell.fp32_compute():
        out = tinycell.run(root, workload, seed=2 ** 33 + 1)
    assert out["correct"], out["compared"]
    assert out["compared"]["widest_gap"]["value"] <= 1e-3
    assert out["compared"]["streams_checked"]["value"] == 2
