"""The captured decode step on the card: ``Engine`` and ``BatchEngine``
replaying one CUDA graph per step against their eager loops (the oracle)
on the same model, weights, rotations and prompts; the kernels' launch
counts per replay; the host room check; and a replay loop under
``torch.cuda.set_sync_debug_mode("error")``.  Marked ``cuda``: skips
where no card is visible (the CPU tests hold the eager step against the
JAX reference).  On the card: ``python -m pytest -q
tests/test_torch_graph.py``.

Tolerances.  A replay runs the same kernels in the same order as the
eager step, so the two are expected to agree bit for bit.  The gate is
``chip_smoke.py``'s: greedy tokens equal, except from a first divergence
at a near-tie (the eager top-2 gap below LOGIT_TOL of its largest
logit), and logits within GRAPH_TOL of the largest logit up to that
step."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import graphs  # noqa: E402
from repro_torch.launch.batch_engine import BatchEngine, Request  # noqa: E402
from repro_torch.launch.engine import GRAPH_KEY, Engine, Sampler  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

pytestmark = pytest.mark.cuda

LOGIT_TOL = 0.05
GRAPH_TOL = 1e-5
S_MAX, NEW = 128, 24
ENGINE_CASES = [("int4-srft", "kernel"), ("int4-srft", "gather"),
                ("bf16", "gather"), ("int4-srft", "blockwise"),
                ("bf16", "blockwise")]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = LM(reduced(get_config("internlm2-1.8b")), device="cuda")
    return model, model.init(model.generator(0))


def _prompt(model, n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, model.cfg.vocab_size, (1, n), generator=g).cuda()


def _per_replay(policy, backend, n_layers, paged=False):
    """Launches of one step (B1, B2, B3, B4): the int4 ring is quantized
    (B3, K and V) every step, the KERNEL read is B1, or B2 when paged."""
    if policy == "bf16":
        return (0, 0, 0, 0)
    read = n_layers if backend == "kernel" else 0
    return (0 if paged else read, read if paged else 0, 2 * n_layers, 0)


def _agree_until(t_ref, t_got, l_ref) -> int:
    """Steps whose logits may be compared: all if the greedy tokens agree,
    else up to a first divergence, which must be a near-tie."""
    diff = (t_ref != t_got).nonzero()
    if not len(diff):
        return t_ref.shape[1]
    b, i = diff[diff[:, 1].argmin()].tolist()
    top2 = l_ref[b, i].topk(2).values
    gap = (top2[0] - top2[1]).item()
    assert gap < LOGIT_TOL * l_ref.abs().max().item(), (
        f"tokens diverge at step {i} with a top-2 gap of {gap}")
    return i + 1


def _generate(model, params, policy, backend, prompt, graph, **kw):
    cache = model.init_cache(1, S_MAX, policy=policy, ragged=True,
                             generator=torch.Generator().manual_seed(3))
    eng = Engine(model, backend=backend, graph=graph, **kw.pop("eng", {}))
    before = graphs.launch_counts()
    toks, lg, cache = eng.generate(params, prompt, cache, NEW,
                                   return_logits=True, **kw)
    after = graphs.launch_counts()
    return eng, cache, toks.cpu(), lg.cpu(), tuple(
        a - b for a, b in zip(after, before))


# 37 tokens end mid-window; after 47 the first decode step fills the
# window and flushes it
@pytest.mark.parametrize("prompt_len", [37, 47], ids=["mid-window", "flush"])
@pytest.mark.parametrize("policy,backend", ENGINE_CASES)
def test_engine_graph_equals_eager(card, policy, backend, prompt_len):
    model, params = card
    prompt = _prompt(model, prompt_len)
    _, _, t_e, l_e, n_e = _generate(model, params, policy, backend, prompt,
                                    False)
    eng, cache, t_g, l_g, n_g = _generate(model, params, policy, backend,
                                          prompt, True)
    assert torch.isfinite(l_g).all() and l_g.shape == l_e.shape
    n = _agree_until(t_e, t_g, l_e)
    err = (l_g[:, :n] - l_e[:, :n]).abs().max().item()
    assert err <= GRAPH_TOL * l_e.abs().max().item(), err
    assert torch.equal(cache["pos"].cpu(), torch.tensor(
        [prompt_len + NEW - 1], dtype=torch.int32))
    # launches: one replay's are the captured step's; the graph run made
    # one step more than the eager run, its warm-up
    per = cache[GRAPH_KEY].step.counts
    assert per == _per_replay(policy, backend, model.cfg.n_layers)
    assert n_g == tuple(e + p for e, p in zip(n_e, per))
    # a second decode reuses the capture; the host checks the room first
    before = graphs.launch_counts()
    more, cache = eng.decode(params, t_g[:, -1:].cuda(), cache, 3)
    assert cache[GRAPH_KEY].step.counts == per
    assert graphs.launch_counts() == tuple(
        b + 3 * p for b, p in zip(before, per))
    with pytest.raises(ValueError, match="cache full"):
        eng.decode(params, more[:, -1:], cache, S_MAX)


def test_engine_replay_loop_makes_no_host_sync(card):
    """Once captured, a decode call is replays and device copies only."""
    model, params = card
    eng, cache, toks, _, _ = _generate(model, params, "int4-srft", "kernel",
                                       _prompt(model, 40), True)
    tok = toks[:, -1:].cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, cache = eng.decode(params, tok, cache, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == (1, 8)


def test_engine_samples_under_the_graph_from_its_generator(card):
    """Temperature and top-k under a graph draw from the registered
    generator: the same seed gives the eager loop's stream; without a
    way to register it, graph sampling raises."""
    model, params = card
    prompt = _prompt(model, 33)
    hot = Sampler(temperature=0.8, top_k=20)
    if not graphs.can_register_generator():
        with pytest.raises(NotImplementedError):
            _generate(model, params, "int4-srft", "kernel", prompt, True,
                      eng=dict(sampler=hot),
                      generator=torch.Generator("cuda").manual_seed(5))
        return
    runs = [_generate(model, params, "int4-srft", "kernel", prompt, graph,
                      eng=dict(sampler=hot),
                      generator=torch.Generator("cuda").manual_seed(5))[2]
            for graph in (False, True, True)]
    assert torch.equal(runs[1], runs[2])
    assert torch.equal(runs[0], runs[1])


def _forced_logits(model, params, policy, backend, prompt, toks, rots):
    """One request alone, eager, teacher-forced on ``toks``: (1, n, V)."""
    cache = model.init_cache(1, S_MAX, policy=policy, rots=rots,
                             ragged=True)
    eng = Engine(model, backend=backend, graph=False)
    lg, cache = eng.prefill(params, torch.as_tensor(prompt).cuda()[None]
                            .long(), cache)
    out = [lg[:, -1].float()]
    for t in toks[:-1]:
        lg, cache = model.decode_step(params, torch.tensor(
            [[int(t)]], device="cuda"), cache, backend=backend)
        out.append(lg[:, -1].float())
    return torch.stack(out, 1).cpu()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("policy,backend", [("int4-srft", "kernel"),
                                            ("bf16", "gather")])
def test_batch_engine_graph_equals_eager(card, policy, backend, paged):
    """Four ragged requests through two slots, eager and graph; paged over
    a pool of one row's pages, so that it preempts.  Streams agree up to a
    near-tie of the request's own single-stream logits; one replay
    launches one step's kernels."""
    model, params = card
    g = torch.Generator().manual_seed(2)
    shape = [(37, 20), (70, 30), (23, 12), (50, 25)]
    reqs = [Request(i, torch.randint(0, model.cfg.vocab_size, (n,),
                                     generator=g).numpy(), m)
            for i, (n, m) in enumerate(shape)]
    out = {}
    for graph in (False, True):
        eng = BatchEngine(model, params, capacity=2, s_max=S_MAX,
                          policy=policy, backend=backend, chunk=4,
                          paged=paged, page_size=16,
                          n_pages=S_MAX // 16 + 1 if paged else None,
                          graph=graph)
        out[graph] = (eng, {c.rid: c for c in eng.run(list(reqs))})
    (eng_e, done_e), (eng_g, done_g) = out[False], out[True]
    for r in reqs:
        want, got = done_e[r.rid], done_g[r.rid]
        assert len(got.tokens) == r.max_new_tokens
        assert got.finish_reason == want.finish_reason == "length"
        if not np.array_equal(got.tokens, want.tokens):
            _agree_until(torch.as_tensor(want.tokens)[None],
                         torch.as_tensor(got.tokens)[None],
                         _forced_logits(model, params, policy, backend,
                                        r.prompt, want.tokens, eng_e._rots))
    if paged:
        assert eng_g.n_preemptions > 0 and eng_e.n_preemptions > 0
        assert eng_g.pool_stats()["pages_used"] == 0
    assert eng_g._step_graph.counts == _per_replay(
        policy, backend, model.cfg.n_layers, paged)
