"""Speculative decoding on a KV cache split by position (split-K):
``Engine.generate_spec`` / ``decode_spec`` over a cache that
``Engine.shard_cache(cache, allow_split_k=True)`` split, the split verify
read (``sharded_cache._seq_verify``) and the rollback of every shard.

The setup is ``tests/test_torch_split_k.py``'s: a simulated ``(1, 3)``
mesh of ``cpu``, a reduced internlm2-1.8b (2 KV heads) or a bare policy
state with 2 KV heads, ``S_MAX`` = 72, so a shard spans 24 positions and
the flush of positions [16, 32) straddles shards 0 and 1; inputs from
numpy seeds.  The engine runs under bf16 dot operands (the card's mode),
where a k-row projection rounds each row as the 1-row one does, and
under ``torch.inference_mode`` (no autograd bookkeeping: a fifth less
host time, the same arithmetic).

What is held, and to what:

  * split-K ``generate_spec`` == split-K ``generate``: tokens bit for bit
    and the cache gathered along the sequence equal below the length and
    in the rings, for each policy, k in {2, 4, 16}, plain and ragged
    caches (a verify query runs the split decode read at its own length,
    so nothing here is a tolerance);
  * each verify query of the split read == the split decode read of the
    state at ``L_i = L0 + i + 1``, bit for bit, on every backend (KERNEL
    reads with GATHER's numerics and calls no B1);
  * a verify pass whose flush straddles two shards, rolled back, leaves
    the gathered state equal to the unsplit truncated state, and both
    decode on to equal bytes;
  * an empty shard weighs 0 in a verify read (the split read is shard 0's
    read bit for bit);
  * against the reference's unsharded ``generate_spec``: tokens up to a
    near-tie, logits within ``tests/test_torch_engine.py``'s LOGIT_TOL;
  * what split-K still refuses raises before it touches the cache.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch.engine import Engine as JEngine  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import cache_api  # noqa: E402
from repro_torch.core.cache_api import get_policy  # noqa: E402
from repro_torch.kernels import quant_attention  # noqa: E402
from repro_torch.launch import partitioning as pt  # noqa: E402
from repro_torch.launch import sharded_cache as sc  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

S_MAX = 72  # 24 positions a shard on m = 3: not a multiple of W = 16
M = 3
W = 16
B, HKV, HQ, D = 2, 2, 4, 32
READ_TOL = 1e-4  # B1's: times max(1, max|out|)
LOGIT_TOL = 0.05  # tests/test_torch_engine.py's, against the reference
# an 11-token prompt and 24 new tokens: the packed length crosses shard
# 0's end (24) at 32, the flush of [16, 32) straddling shards 0 and 1 is
# written, rolled back and rewritten by the verify passes around it
PROMPT, NEW = 11, 24
POLICIES = ["int4-srft", "bf16", "int8-per-token"]
KEPT = "only through BatchEngine"  # the kept refusals' message


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, M), ("data", "model"), devices=["cpu"] * M)


@pytest.fixture(scope="module")
def lm():
    model = LM(reduced(get_config("internlm2-1.8b")), device="cpu")
    base = np.random.default_rng(1).integers(0, model.cfg.vocab_size, (1, 6))
    prompt = torch.from_numpy(np.tile(base, (1, 2))[:, :PROMPT]).long()
    return model, model.init(torch.Generator().manual_seed(0)), prompt


def _split_cache(eng, model, policy, ragged):
    cache = eng.shard_cache(model.init_cache(1, S_MAX, policy=policy,
                                             ragged=ragged),
                            allow_split_k=True)
    assert all(st.seq_split for st in cache["attn"])
    return cache


_PLAIN = {}


def _plain_run(lm, mesh, policy, ragged):
    """Split-K ``generate`` of the prompt (the stream a spec run is held
    to), memoized per (policy, layout): tokens and every layer's state
    gathered along the sequence."""
    key = (policy, ragged)
    if key not in _PLAIN:
        model, params, prompt = lm
        eng = Engine(model, backend="gather", graph=False, mesh=mesh)
        with torch.inference_mode(), common.dot_mode(True):
            toks, cache = eng.generate(
                params, prompt, _split_cache(eng, model, policy, ragged), NEW)
        _PLAIN[key] = toks, [sc.gather_state(st) for st in cache["attn"]]
    return _PLAIN[key]


def _readable(state):
    """What a read of ``state`` (unsharded) can see: each seq-major leaf
    below the packed length (int4) or the length, the residual rings,
    the length."""
    d = state.data
    L = int(d.length if isinstance(d.length, int) else d.length.max())
    if hasattr(d, "kv"):
        n = L - L % W
        kv = d.kv
        return [t[:, :, :n] for t in sc._seq_leaves(d)] + \
            [kv.k_residual, kv.v_residual, torch.as_tensor(L)]
    return [t[:, :, :L] for t in sc._seq_leaves(d)] + [torch.as_tensor(L)]


@pytest.mark.parametrize("ragged", [False, True], ids=["plain", "ragged"])
@pytest.mark.parametrize("k", [2, 4, 16])
@pytest.mark.parametrize("policy", POLICIES)
def test_split_k_spec_equals_split_k_plain(lm, mesh, policy, k, ragged):
    """generate_spec == generate on split caches: tokens bit for bit, and
    every layer's gathered bytes below the length and in the rings."""
    model, params, prompt = lm
    want, want_states = _plain_run(lm, mesh, policy, ragged)
    eng = Engine(model, backend="gather", graph=False, mesh=mesh)
    with torch.inference_mode(), common.dot_mode(True):
        got, cache, stats = eng.generate_spec(
            params, prompt, _split_cache(eng, model, policy, ragged), NEW,
            spec_k=k)
    assert torch.equal(got, want)
    assert 0 <= stats["accepted"] <= stats["drafted"]
    assert stats["passes"] > 0
    pos = cache["pos"] if not ragged else int(cache["pos"][0])
    assert pos == PROMPT + NEW - 1
    for i, (st, ref) in enumerate(zip(cache["attn"], want_states)):
        for j, (a, b) in enumerate(zip(_readable(ref),
                                       _readable(sc.gather_state(st)))):
            assert torch.equal(a, b), f"layer {i} leaf {j}"


def _kv(rng, n):
    return tuple(torch.from_numpy(rng.standard_normal((B, HKV, n, D))
                                  .astype(np.float32)).to(torch.bfloat16)
                 for _ in "kv")


def _clone(state):
    """A deep copy of a (split or unsplit) state's tensors."""
    def one(s):
        return pt.tree_map_with_path(
            lambda _, t: t.clone() if isinstance(t, torch.Tensor) else t, s)

    if isinstance(state, sc.ShardedState):
        return state.map_shards(one)
    return one(state)


def _pair(policy, mesh, ragged=True):
    pol = get_policy(policy, group=32, window=W)

    def mk():
        return pol.init_state(B, HKV, S_MAX, D, device="cpu", ragged=ragged,
                              generator=torch.Generator().manual_seed(3))

    return pol, mk(), sc.shard_state(mk(), mesh, allow_split_k=True)


def _verify_case(policy, mesh, n_prompt, k, seed):
    """A split state prefilled with ``n_prompt`` tokens, row 1 held back
    three appends (rows at different lengths), then a verify pass's k
    appends after a snapshot.  Returns (state after the pass, the state
    before it, snapshot, k appended K/V, queries (B, HQ, k, D) fp32)."""
    pol, _, split = _pair(policy, mesh)
    rng = np.random.default_rng(seed)
    split.policy.prefill(split, *_kv(rng, n_prompt))
    for i in range(5):
        active = torch.tensor([True, i >= 3])
        split.policy.update(split, *_kv(rng, 1), active=active)
    before = _clone(split)
    snap = split.policy.snapshot_rows(split)
    appended = [_kv(rng, 1) for _ in range(k)]
    for kk, vv in appended:
        split.policy.update(split, kk, vv)
    q = torch.from_numpy(rng.standard_normal((B, HQ, k, D)).astype(
        np.float32))
    return split, before, snap, appended, q


@pytest.mark.parametrize("policy", POLICIES)
def test_each_verify_query_is_the_split_decode_read(policy, mesh,
                                                    monkeypatch):
    """Rows at 16 and 13 tokens, k = 16 appends: the pass writes the
    flush of [16, 32) across shards 0 and 1 for row 0 and wraps both
    rings.  Query i's split verify read == the split decode read of the
    state that appended tokens 0..i, bit for bit; the KERNEL verify reads
    the same bits and calls no B1."""
    k = 16
    split, before, snap, appended, q = _verify_case(policy, mesh, 11, k, 21)
    got = split.policy.verify_attend(q, split, snap)
    state = _clone(before)
    for i, (kk, vv) in enumerate(appended):
        state.policy.update(state, kk, vv)
        want = state.policy.attend(q[:, :, i:i + 1], state, backend="gather")
        assert torch.equal(got[:, :, i:i + 1], want), f"query {i}"

    def refuse(*a, **kw):
        raise AssertionError("a verify pass called a B1 wrapper")

    monkeypatch.setattr(quant_attention, "decode_attention_kernel", refuse)
    monkeypatch.setattr(cache_api, "_KERNEL_VERIFY_WARNED", True)
    for backend in ("kernel", "blockwise"):
        if backend not in [b.value for b in split.policy.supported_backends]:
            continue
        assert torch.equal(split.policy.verify_attend(
            q, split, snap, backend=backend), got), backend


@pytest.mark.parametrize("policy", POLICIES)
def test_rollback_of_a_flush_straddling_shards(policy, mesh):
    """From 20 tokens, a 16-token pass appends [20, 36): int4 flushes
    [16, 32) into shards 0 and 1.  Rolled back to 22 (the flush
    rejected), the gathered split state equals the unsplit state
    truncated alike, every byte; then both decode on past 32, rewriting
    the flush, and stay equal."""
    pol, plain, split = _pair(policy, mesh)
    rng = np.random.default_rng(31)
    k, v = _kv(rng, 20)
    pol.prefill(plain, k, v)
    split.policy.prefill(split, k, v)
    snaps = (pol.snapshot_rows(plain), split.policy.snapshot_rows(split))
    base = plain.length.clone()
    before = [[t.clone() for t in sc._seq_leaves(s.data)]
              for s in split.shards]
    for _ in range(16):
        kv = _kv(rng, 1)
        pol.update(plain, *kv)
        split.policy.update(split, *kv)
    if policy == "int4-srft":
        # the slab of [16, 32): positions 16..23 of shard 0, 0..7 of 1
        for j, span in ((0, slice(16, 24)), (1, slice(0, 8))):
            for b4, s in zip(before[j], sc._seq_leaves(split.shards[j].data)):
                assert not torch.equal(b4[:, :, span], s[:, :, span]), j
    new = base + 2
    pol.truncate_rows(plain, new, snaps[0])
    split.policy.truncate_rows(split, new, snaps[1])
    _assert_bytes_equal(plain, split, "after the rollback")
    assert all(torch.equal(s.length, new) for s in split.shards)
    q = torch.from_numpy(rng.standard_normal((B, HQ, 1, D)).astype(
        np.float32))
    for step in range(14):
        kv = _kv(rng, 1)
        pol.update(plain, *kv)
        split.policy.update(split, *kv)
        _assert_bytes_equal(plain, split, f"decode step {step}")
    want = pol.attend(q, plain)
    got = split.policy.attend(q, split)
    assert (got - want).abs().max() <= READ_TOL * max(1.0,
                                                      want.abs().max())


def _assert_bytes_equal(plain, split, tag):
    got = pt.flatten_with_path(sc.gather_state(split))
    want = pt.flatten_with_path(plain)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(want, got):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f"{tag}: leaf {path}"
        else:
            assert a == b, f"{tag}: leaf {path}"


@pytest.mark.parametrize("policy", POLICIES)
def test_an_empty_shard_weighs_zero_in_a_verify_read(policy, mesh):
    """5 tokens and a 4-token pass: shards 1 and 2 hold nothing a query
    may see, so each query's combine is shard 0's part bit for bit: the
    split verify equals the policy's own verify of shard 0 alone, and is
    within B1's tolerance of the unsplit verify."""
    pol, plain, split = _pair(policy, mesh, ragged=False)
    rng = np.random.default_rng(41)
    k, v = _kv(rng, 5)
    pol.prefill(plain, k, v)
    split.policy.prefill(split, k, v)
    snaps = (pol.snapshot_rows(plain), split.policy.snapshot_rows(split))
    for _ in range(4):
        kv = _kv(rng, 1)
        pol.update(plain, *kv)
        split.policy.update(split, *kv)
    q = torch.from_numpy(rng.standard_normal((B, HQ, 4, D)).astype(
        np.float32))
    got = split.policy.verify_attend(q, split, snaps[1])
    alone = pol.verify_attend(q, split.shards[0], snaps[1][0])
    assert torch.isfinite(got).all()
    assert torch.equal(got, alone)
    want = pol.verify_attend(q, plain, snaps[0])
    assert (got - want).abs().max() <= READ_TOL * max(1.0,
                                                      want.abs().max())


def _reference_params(params) -> dict:
    """The port's params as the reference's tree, bit for bit: each
    block's leaves stacked along a leading layer axis (the inverse of
    ``bridge.lm_params``), bf16 carried as its bits."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    def tree(x):
        return ({k: tree(v) for k, v in x.items()} if isinstance(x, dict)
                else leaf(x))

    out = {k: tree(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = jax.tree.map(lambda *xs: np.stack(xs),
                                 *[tree(b) for b in params["blocks"]])
    return jax.tree.map(jnp.asarray, out)


def test_split_k_spec_against_the_reference(lm, mesh):
    """The port's split-K ``generate_spec`` (int4-srft KERNEL: B1's plain
    version per shard in the plain stream, GATHER's numerics in the
    verify) against the reference's unsharded ``generate_spec`` on the
    port's weights carried across and the reference's rotations bridged:
    tokens up to a near-tie of the reference's logits, logits of the
    port's split-K stream within LOGIT_TOL of the reference's per-step
    loop."""
    model, params, _ = lm
    jcfg = jreduced(jget_config("internlm2-1.8b"))
    jm = build_model(jcfg)
    jp = _reference_params(params)
    new = 20
    base = np.random.default_rng(2).integers(0, jcfg.vocab_size, (1, 6))
    toks = np.tile(base, (1, 7))[:, :37].astype(np.int32)

    cache = jax.jit(lambda key: jm.init_cache(1, S_MAX, policy="int4-srft",
                                              key=key))(
        jax.random.PRNGKey(7))
    # not donated: the same cache seeds the per-step loop below, which
    # reuses the engine's compiled prefill
    jeng = JEngine(jm, donate=False)
    ref_spec, _, _ = jeng.generate_spec(jp, jnp.asarray(toks), cache, new,
                                        spec_k=4)
    ref_spec = np.asarray(ref_spec)
    data = cache["attn"].data
    rots = bridge.rotations({
        side: {f: np.asarray(getattr(getattr(data, f"rot_{side}"), f))
               for f in ("matrix", "lam", "signs")} for side in ("k", "v")})
    logits, cache = jeng.prefill(jp, jnp.asarray(toks), cache)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    ref_l = [np.asarray(logits[:, -1])]
    step = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, backend="gather"))
    for _ in range(new - 1):
        logits, cache = step(jp, tok, cache)
        tok = jnp.asarray(ref_spec[:, len(ref_l):len(ref_l) + 1])
        ref_l.append(np.asarray(logits[:, -1]))
    ref_l = np.stack(ref_l, 1)
    tol = LOGIT_TOL * np.abs(ref_l).max()

    eng = Engine(model, backend="kernel", graph=False, mesh=mesh)
    prompt = torch.from_numpy(toks).long()

    def split():
        return eng.shard_cache(model.init_cache(
            1, S_MAX, policy="int4-srft", rots=rots, ragged=True),
            allow_split_k=True)

    with torch.inference_mode():
        got_t, _, stats = eng.generate_spec(eng.shard_params(params), prompt,
                                            split(), new, spec_k=4)
        _, got_l, _ = eng.generate(eng.shard_params(params), prompt,
                                   split(), new, return_logits=True)
    got_t, got_l = got_t.numpy(), got_l.numpy()
    diverged = np.argwhere(got_t != ref_spec)
    if len(diverged):
        i = diverged[:, 1].min()
        top2 = np.sort(ref_l[0, i])[-2:]
        assert top2[1] - top2[0] < tol, f"diverged at step {i}"
    n_same = diverged[:, 1].min() + 1 if len(diverged) else new
    assert np.abs(got_l[:, :n_same] - ref_l[:, :n_same]).max() <= tol
    assert stats["passes"] > 0


def test_split_k_still_refuses_what_only_batch_engine_reaches(mesh):
    """chunked prefill, the raw view, admission and the host tier, and a
    sliding-window read, on a state split by position: NotImplementedError
    with the reason, before the state is touched; no message names a
    ROADMAP label."""
    for policy in POLICIES:
        _, _, split = _pair(policy, mesh)
        pol = split.policy
        split.policy.prefill(split, *_kv(np.random.default_rng(0), 9))
        before = [t.clone() for _, t in pt.flatten_with_path(
            sc.gather_state(split)) if isinstance(t, torch.Tensor)]
        other = _pair(policy, mesh)[2]
        calls = {
            "prefill_chunk": lambda: pol.prefill_chunk(
                split, *_kv(np.random.default_rng(1), 16)),
            "raw_kv_view": lambda: pol.raw_kv_view(split, 8),
            "insert_row": lambda: pol.insert_row(split, other, 0),
            "insert_row_paged": lambda: pol.insert_row_paged(
                split, other, 0, None, 0, 0),
            "adopt_prefix": lambda: pol.adopt_prefix(split, other, None, 0),
            "export_pages": lambda: pol.export_pages(split, [0]),
            "import_pages": lambda: pol.import_pages(split, (), 0),
        }
        for what, call in calls.items():
            with pytest.raises(NotImplementedError, match=KEPT) as e:
                call()
            assert what in str(e.value) and "A12" not in str(e.value)
        q = torch.zeros((B, HQ, 1, D))
        for read in (lambda: pol.attend(q, split, sliding_window=8),
                     lambda: pol.verify_attend(
                         q, split, pol.snapshot_rows(split),
                         sliding_window=8)):
            with pytest.raises(NotImplementedError,
                               match="no config") as e:
                read()
            assert "A12" not in str(e.value)
        after = [t for _, t in pt.flatten_with_path(sc.gather_state(split))
                 if isinstance(t, torch.Tensor)]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
