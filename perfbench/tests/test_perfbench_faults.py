"""A run with the timed path broken underneath comes out not correct,
once for each fault a served cell can have: a token altered where it is
produced, and a step that leaves the cache as it was.  The look for a
card is skipped: the run is on the CPU at a reduced size, the port in
float32, where a sound run reads a widest gap of zero."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tinycell  # noqa: E402

import pytest  # noqa: E402

from perfbench import harness  # noqa: E402
from repro_torch.core import cache_api  # noqa: E402

LIMIT = 1e-3


class _Altering:
    """Greedy, but every 7th draw takes the next token id."""

    temperature = 0.0

    def __init__(self, vocab):
        self.vocab, self.n = vocab, 0

    def sample(self, logits, generator=None):
        tok = logits.argmax(dim=-1)
        self.n += 1
        return (tok + 1) % self.vocab if self.n % 7 == 0 else tok


@pytest.fixture
def root(tmp_path):
    return tinycell.make_copy(tmp_path, limit=LIMIT)


def _with_engine_patch(monkeypatch, patch):
    build = harness.build

    def patched(*a, **k):
        params, signs, eng, rec = build(*a, **k)
        patch(eng)
        return params, signs, eng, rec

    monkeypatch.setattr(harness, "build", patched)


@pytest.mark.parametrize("workload", ["tiny-fixed", "tiny-open"])
def test_sound_run_is_correct(root, workload):
    with tinycell.fp32_compute():
        out = tinycell.run(root, workload, seed=31)
    assert out["correct"]


@pytest.mark.parametrize("workload", ["tiny-fixed", "tiny-open"])
def test_altered_token_is_not_correct(root, monkeypatch, workload):
    _with_engine_patch(monkeypatch, lambda eng: setattr(
        eng, "sampler", _Altering(eng.model.cfg.vocab_size)))
    with tinycell.fp32_compute():
        out = tinycell.run(root, workload, seed=31)
    assert not out["correct"]
    assert out["compared"]["widest_gap"]["value"] > LIMIT


@pytest.mark.parametrize("workload", ["tiny-fixed", "tiny-open"])
def test_step_that_keeps_the_cache_is_not_correct(root, monkeypatch,
                                                  workload):
    """Decode appends nothing: the cache stays as the prefill left it."""
    monkeypatch.setattr(cache_api.Int4SRFTPolicy, "update",
                        lambda self, state, k, v, active=None: state)
    with tinycell.fp32_compute():
        out = tinycell.run(root, workload, seed=31)
    assert not out["correct"]
    assert out["compared"]["widest_gap"]["value"] > LIMIT
