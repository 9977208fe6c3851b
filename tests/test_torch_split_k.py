"""Split-K serving in the port: a dense KV cache split by position over a
mesh's 'model' axis where its KV heads do not divide it
(``Engine.shard_cache(cache, allow_split_k=True)``,
``launch/sharded_cache.py``), and the log-sum-exp every decode read
hands out so that the shards' parts can be combined.

The mesh is a simulated ``(1, 3)`` mesh of ``cpu``: a reduced
internlm2-1.8b (2 KV heads) or a bare policy state with 2 KV heads, so
3 does not divide the heads and the sequence axis takes 'model'.  With
``S_MAX`` = 72 a shard holds 24 positions, not a multiple of the flush
window W = 16, so the flush of positions [16, 32) straddles shards 0
and 1.

What is held, and to what:

  * writes: the same K/V into a split and an unsplit state leave the
    same bytes (the split state gathered along the sequence), bit for
    bit, after every step, for all three policies, plain and ragged;
  * reads: the split read of a seeded fp32 query is within B1's
    ``1e-4 * max(1, max|out|)`` of the unsplit read (the softmax
    combine re-associates, so no bit-identity is claimed), for every
    read path of every policy; a shard with nothing to read has
    log-sum-exp -1e30, weight exactly 0 and a finite output;
  * each plain read's log-sum-exp equals ``torch.logsumexp`` of its
    masked scaled scores;
  * the engine: forced decoding (the unsplit run's tokens fed in) keeps
    layer 0's cache bit-equal at every step (its K/V depend on the tokens
    alone; a deeper layer's are computed from the split read below it)
    and every layer's after the prefill, with logits within
    ``ENGINE_TOL`` of the largest; free-running greedy streams equal up
    to a near-tie; against the reference's unsharded engine within
    ``tests/test_torch_engine.py``'s LOGIT_TOL.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import kvcache  # noqa: E402
from repro_torch.core.cache_api import get_policy  # noqa: E402
from repro_torch.core.quant_attention_ref import (  # noqa: E402
    decode_attention_bf16,
    decode_attention_bf16_blockwise,
    decode_attention_quant,
    decode_attention_quant_blockwise,
)
from repro_torch.kernels.quant_attention import decode_attention_kernel  # noqa: E402,E501
from repro_torch.kernels.quant_attention.ref import quant_decode_attention_ref  # noqa: E402,E501
from repro_torch.launch import partitioning as pt  # noqa: E402
from repro_torch.launch import sharded_cache as sc  # noqa: E402
from repro_torch.launch.engine import Engine  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

S_MAX = 72  # 24 positions a shard on m = 3: not a multiple of W = 16
M = 3
B, HKV, HQ, D = 2, 2, 4, 32
READ_TOL = 1e-4  # B1's: times max(1, max|out|)
ENGINE_TOL = 0.02  # of the largest logit: bf16 activations, random weights
LOGIT_TOL = 0.05  # tests/test_torch_engine.py's, against the reference
NEG = -1e30
N_NEW = 20
READS = [("bf16", "gather"), ("bf16", "blockwise"),
         ("int8-per-token", "gather"), ("int4-srft", "gather"),
         ("int4-srft", "blockwise"), ("int4-srft", "kernel")]


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
    return model, model.init(torch.Generator().manual_seed(0))


def _kv(rng, n):
    return tuple(torch.from_numpy(rng.standard_normal((B, HKV, n, D))
                                  .astype(np.float32)).to(torch.bfloat16)
                 for _ in "kv")


def _states(policy, mesh, ragged):
    pol = get_policy(policy, group=32, window=16)
    mk = lambda: pol.init_state(B, HKV, S_MAX, D, device="cpu",  # noqa: E731
                                ragged=ragged,
                                generator=torch.Generator().manual_seed(3))
    plain = mk()
    split = sc.shard_state(mk(), mesh, allow_split_k=True)
    assert isinstance(split, sc.ShardedState) and split.seq_split
    assert split.span == S_MAX // M and split.s_max == S_MAX
    return pol, plain, split


def _assert_bytes_equal(plain, split, tag):
    got = pt.flatten_with_path(sc.gather_state(split))
    want = pt.flatten_with_path(plain)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(want, got):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f"{tag}: leaf {path}"
        else:
            assert a == b, f"{tag}: leaf {path}"


def _fill(policy, mesh, ragged, n_prompt, n_steps, check=None):
    """Prefill ``n_prompt`` tokens and append ``n_steps`` into a split and
    an unsplit state with the same K/V; ``check(step, plain, split)``
    after every write."""
    pol, plain, split = _states(policy, mesh, ragged)
    rng = np.random.default_rng(11)
    k, v = _kv(rng, n_prompt)
    pol.prefill(plain, k, v)
    split.policy.prefill(split, k, v)
    if check:
        check(-1, plain, split)
    for i in range(n_steps):
        k, v = _kv(rng, 1)
        active = (torch.tensor([True, i % 3 != 1]) if ragged else None)
        pol.update(plain, k, v, active=active)
        split.policy.update(split, k, v, active=active)
        if check:
            check(i, plain, split)
    return pol, plain, split


@pytest.mark.parametrize("ragged", [False, True], ids=["plain", "ragged"])
@pytest.mark.parametrize("policy", ["bf16", "int4-srft", "int8-per-token"])
def test_split_writes_leave_the_unsplit_bytes(policy, ragged, mesh):
    """Prefill of 21 tokens (int4: 16 packed, 5 in the ring), then 40
    appends; the flush of [16, 32) straddles shards 0 and 1 and must land
    in both, and every later write in its owner."""
    n = S_MAX // M
    seen = {}

    def check(step, plain, split):
        _assert_bytes_equal(plain, split, f"{policy} step {step}")
        seen[step] = [[t.clone() for t in sc._seq_leaves(s.data)]
                      for s in split.shards]

    _fill(policy, mesh, ragged, 21, 40, check)
    if policy == "int4-srft":
        # row 0 reaches length 32 at the append of step 10 (21 + 11): the
        # window [16, 32) flushes, writing positions 16..23 of shard 0 and
        # 0..7 of shard 1
        before, after = seen[9], seen[10]
        for j, span in ((0, slice(16, n)), (1, slice(0, 32 - n))):
            for b4, af in zip(before[j], after[j]):
                assert not torch.equal(b4[0, :, span], af[0, :, span]), \
                    f"the straddling flush missed shard {j}"
        assert all(torch.equal(x, y) for x, y in zip(before[2], after[2]))


@pytest.mark.parametrize("policy,backend", READS,
                         ids=[f"{p}-{b}" for p, b in READS])
def test_split_read_is_within_b1_tolerance_of_the_unsplit_read(
        policy, backend, mesh):
    """Rows at different lengths (one spanning all three shards); an fp32
    query; the split read against the unsplit one."""
    pol, plain, split = _fill(policy, mesh, True, 21, 45)
    q = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, HQ, 1, D)).astype(np.float32))
    kw = dict(backend=backend, kv_block=16)
    want = pol.attend(q, plain, **kw)
    got = split.policy.attend(q, split, **kw)
    assert got.dtype == want.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= READ_TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("policy,backend", READS,
                         ids=[f"{p}-{b}" for p, b in READS])
def test_an_empty_shard_weighs_zero(policy, backend, mesh):
    """10 tokens: shards 1 and 2 have nothing to read.  Their parts have
    log-sum-exp -1e30 and finite outputs, weigh exactly 0, so the split
    read is shard 0's part bit for bit."""
    pol, plain, split = _fill(policy, mesh, False, 10, 0)
    q = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, HQ, 1, D)).astype(np.float32))
    kw = dict(backend=backend, kv_block=16)
    rotated = policy == "int4-srft"
    qr = (q @ split.data.rot_k.folded_query_matrix().T) if rotated else q
    parts = []
    for j, s in enumerate(split.shards):
        n_j = 10 if j == 0 else 0
        view = sc._with_length(s, n_j)
        if rotated:
            view = sc._RotatedSpace.over(view)
            parts.append(pol.attend(qr, view, packed_len=0, return_lse=True,
                                    **kw))
        else:
            parts.append(pol.attend(qr, view, return_lse=True, **kw))
    for out, lse in parts[1:]:
        assert torch.isfinite(out).all()
        assert (lse == NEG).all()
    outs, lses = zip(*parts)
    w = torch.exp(torch.stack(lses) - torch.stack(lses).amax(0))
    assert (w[1:] == 0).all() and (w[0] == 1).all()
    combined = sc._combine(list(outs), list(lses))
    assert torch.equal(combined, outs[0])
    got = split.policy.attend(q, split, **kw)
    want = pol.attend(q, plain, **kw)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= READ_TOL * max(1.0,
                                                      want.abs().max())


def _scores(q, k, sm):
    """(B, Hq, 1, S) scaled scores of q (B, Hq, 1, d) against k (B, Hkv,
    S, d), grouped."""
    Bq, Hq, _, d = q.shape
    qg = q.float().reshape(Bq, k.shape[1], Hq // k.shape[1], d)
    return (torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * sm).reshape(
        Bq, Hq, 1, -1)


@pytest.mark.parametrize("read", ["bf16-gather", "bf16-blockwise",
                                  "int8-gather", "int4-gather",
                                  "int4-blockwise", "b1-plain"])
def test_plain_reads_lse_is_logsumexp_of_masked_scores(read, mesh):
    """Per row lengths 45 and 31 (int4: packed 32 + 13 in the ring, and
    16 + 15): each read's log-sum-exp against ``torch.logsumexp`` of the
    valid positions' scaled scores; and a zero-length row gives the
    -1e30 sentinel."""
    policy = {"bf16": "bf16", "int8": "int8-per-token",
              "int4": "int4-srft", "b1": "int4-srft"}[read.split("-")[0]]
    pol, plain, _ = _fill(policy, mesh, True, 21, 24)
    L = plain.length.clone()
    q = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, HQ, 1, D)).astype(np.float32))
    sm = D ** -0.5
    pos = torch.arange(S_MAX)
    if policy == "int4-srft":
        d = plain.data
        kv = d.kv
        yk, _, plen = kvcache.gather_rotated(kv)
        qf = q @ d.rot_k.folded_query_matrix().T
        packed = torch.where(pos[None, :] < plen[:, None],
                             0.0, -torch.inf)[:, None, None]
        ring_pos = plen[:, None] + torch.arange(16)
        ring = torch.where(ring_pos < L[:, None], 0.0,
                           -torch.inf)[:, None, None]
        want = torch.logsumexp(torch.cat(
            [_scores(qf, yk, sm) + packed,
             _scores(qf, kv.k_residual, sm) + ring], dim=-1), dim=-1)
        if read == "b1-plain":
            q_eff = (qf * sm).reshape(B * HKV, HQ // HKV, D)

            def flat(x):
                return x.reshape(B * HKV, *x.shape[2:])

            rows = lambda x: x[:, None].expand(B, HKV).reshape(-1)  # noqa
            _, lse = quant_decode_attention_ref(
                q_eff, flat(kv.k_packed), flat(kv.k_scales),
                flat(kv.v_packed), flat(kv.v_scales), flat(kv.k_residual),
                flat(kv.v_residual), rows(plen), rows(L), group=32,
                return_lse=True)
            lse = lse.reshape(B, HQ, 1)
            _, lse2 = decode_attention_kernel(q, kv, d.rot_k, d.rot_v,
                                              return_lse=True)
            assert torch.equal(lse, lse2)
        else:
            fn = (decode_attention_quant if read == "int4-gather"
                  else decode_attention_quant_blockwise)
            _, lse = fn(q, kv, d.rot_k, d.rot_v, return_lse=True)
        empty = dataclasses.replace(kv, length=torch.zeros_like(L))
        _, lse0 = decode_attention_quant(q, empty, d.rot_k, d.rot_v,
                                         return_lse=True)
    else:
        if policy == "bf16":
            k = plain.data.k
        else:
            k = pol._dequantized(plain).k
        mask = torch.where(pos[None, :] < L[:, None], 0.0,
                           -torch.inf)[:, None, None]
        want = torch.logsumexp(_scores(q, k, sm) + mask, dim=-1)
        if read == "bf16-blockwise":
            fn = lambda q_, c: decode_attention_bf16_blockwise(  # noqa
                q_, c, kv_block=16, return_lse=True)
        else:
            fn = lambda q_, c: decode_attention_bf16(  # noqa
                q_, c, return_lse=True)
        data = plain.data if policy == "bf16" else pol._dequantized(plain)
        _, lse = fn(q, data)
        if read == "int8-gather":
            _, lse2 = pol.attend(q, plain, return_lse=True)
            assert torch.equal(lse, lse2)
        _, lse0 = fn(q, dataclasses.replace(data,
                                            length=torch.zeros_like(L)))
    assert lse.shape == (B, HQ, 1)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    assert (lse0 == NEG).all()


def _copy(state):
    """A copy of a state's bytes (gathered along the sequence if split)."""
    if isinstance(state, sc.ShardedState):
        return sc.gather_state(state)
    return pt.tree_map_with_path(
        lambda _, t: t.clone() if isinstance(t, torch.Tensor) else t, state)


def _forced(model, params, prompt, cache, tokens, backend):
    """Prefill, then decode feeding ``tokens`` (the unsplit run's);
    per-step last logits and, after every step, layer 0's state."""
    logits, cache = Engine(model, backend=backend).prefill(params, prompt,
                                                           cache)
    out, layer0 = [logits[:, -1].float()], []
    after_prefill = [_copy(st) for st in cache["attn"]]
    for i in range(tokens.shape[1] - 1):
        logits, _ = model.decode_step(params, tokens[:, i:i + 1], cache,
                                      kv_block=16, backend=backend)
        out.append(logits[:, -1].float())
        layer0.append(_copy(cache["attn"][0]))
    return torch.stack(out, 1), after_prefill, layer0


@pytest.mark.parametrize("policy,backend", READS,
                         ids=[f"{p}-{b}" for p, b in READS])
def test_split_k_engine_against_the_unsplit_engine(policy, backend, lm,
                                                   mesh):
    """A 37-token prompt (its packed bulk [0, 32) straddles shards 0 and
    1; shard 2 empty at first), then 20 new tokens: the flush of [32, 48)
    at shard 1's end and the first appends into shard 2."""
    model, params = lm
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (1, 37)))
    ref = Engine(model, backend=backend, graph=False)
    toks, logits, ref_cache = ref.generate(
        params, prompt, model.init_cache(1, S_MAX, policy=policy,
                                         ragged=True), N_NEW,
        return_logits=True)
    eng = Engine(model, backend=backend, graph=False, mesh=mesh)
    cache = eng.shard_cache(model.init_cache(1, S_MAX, policy=policy,
                                             ragged=True),
                            allow_split_k=True)
    assert all(st.seq_split for st in cache["attn"])
    got_t, got_l, cache = eng.generate(eng.shard_params(params), prompt,
                                       cache, N_NEW, return_logits=True)
    tol = ENGINE_TOL * logits.abs().max().item()
    diverged = torch.nonzero(got_t != toks)
    if len(diverged):
        i = int(diverged[:, 1].min())
        top2 = logits[0, i].sort().values[-2:]
        assert top2[1] - top2[0] < tol, f"diverged at step {i}"
    n_same = int(diverged[:, 1].min()) + 1 if len(diverged) else N_NEW
    assert (got_l[:, :n_same] - logits[:, :n_same]).abs().max() <= tol

    # forced decoding on the unsplit run's tokens
    def run(split):
        c = model.init_cache(1, S_MAX, policy=policy, ragged=True)
        if split:
            c = eng.shard_cache(c, allow_split_k=True)
        return _forced(model, params, prompt, c, toks, backend)

    (want_l, want_pre, want_0), (got_l, got_pre, got_0) = run(False), \
        run(True)
    assert (got_l - want_l).abs().max() <= tol
    for a, b in zip(want_pre, got_pre):
        _assert_bytes_equal(a, b, "after the prefill")
    for i, (a, b) in enumerate(zip(want_0, got_0)):
        _assert_bytes_equal(a, b, f"layer 0 at step {i}")


def test_split_k_engine_against_the_reference(mesh):
    """Across the packages: the port's split-K ``Engine`` (int4-srft
    KERNEL, B1's plain version per shard) against the reference's
    unsharded per-step loop on bridged weights and rotations: tokens up
    to a near-tie, logits within LOGIT_TOL of the largest."""
    jcfg = jreduced(jget_config("internlm2-1.8b"))
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = LM(reduced(get_config("internlm2-1.8b")), device="cpu")
    params = bridge.lm_params(jax.tree.map(np.asarray, jp))
    new = 20
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (1, 37)).astype(np.int32)
    cache = jm.init_cache(1, S_MAX, policy="int4-srft",
                          key=jax.random.PRNGKey(7))
    logits, cache = jax.jit(jm.prefill)(jp, jnp.asarray(toks), cache)
    data = cache["attn"].data
    rots = bridge.rotations({
        side: {f: np.asarray(getattr(getattr(data, f"rot_{side}"), f))
               for f in ("matrix", "lam", "signs")} for side in ("k", "v")})
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    ref_t, ref_l = [np.asarray(tok)], [np.asarray(logits[:, -1])]
    step = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, backend="gather"))
    for _ in range(new - 1):
        logits, cache = step(jp, tok, cache)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        ref_t.append(np.asarray(tok))
        ref_l.append(np.asarray(logits[:, -1]))
    ref_t, ref_l = np.concatenate(ref_t, 1), np.stack(ref_l, 1)
    tol = LOGIT_TOL * np.abs(ref_l).max()

    eng = Engine(model, backend="kernel", graph=False, mesh=mesh)
    tcache = eng.shard_cache(model.init_cache(1, S_MAX, policy="int4-srft",
                                              rots=rots, ragged=True),
                             allow_split_k=True)
    assert tcache["attn"][0].seq_split
    got_t, got_l, _ = eng.generate(eng.shard_params(params),
                                   torch.from_numpy(toks).long(), tcache,
                                   new, return_logits=True)
    got_t, got_l = got_t.numpy(), got_l.numpy()
    diverged = np.argwhere(got_t != ref_t)
    if len(diverged):
        b, i = diverged[np.argmin(diverged[:, 1])]
        top2 = np.sort(ref_l[b, i])[-2:]
        assert top2[1] - top2[0] < tol, f"diverged at step {i}"
    n_same = diverged[:, 1].min() + 1 if len(diverged) else new
    assert np.abs(got_l[:, :n_same] - ref_l[:, :n_same]).max() <= tol


def test_split_k_bytes_and_what_it_refuses(lm, mesh):
    """``nbytes``: global-logical equals the unsplit state's; one shard
    holds S/m of the seq-major bytes and the rings in full.  The
    speculative rollback is served (``snapshot_rows``, ``truncate_rows``,
    ``generate_spec``: tests/test_torch_split_k_spec.py holds them);
    what split-K does not serve (chunked prefill, which the reference
    reaches only through BatchEngine) raises NotImplementedError saying
    so, before it touches the cache."""
    model, params = lm
    for policy in ("bf16", "int4-srft", "int8-per-token"):
        pol, plain, split = _states(policy, mesh, True)
        for po in (True, False):
            assert split.nbytes(persistent_only=po) == \
                plain.nbytes(persistent_only=po)
        seq = sum(t.numel() * t.element_size()
                  for t in sc._seq_leaves(plain.data))
        rings = plain.nbytes(persistent_only=False) - plain.nbytes()
        assert split.nbytes(per_shard=True) == seq // M
        assert split.nbytes(persistent_only=False, per_shard=True) == \
            seq // M + rings
        snap = split.policy.snapshot_rows(split)
        assert len(snap) == M
        split.policy.truncate_rows(split, torch.zeros(B, dtype=torch.long),
                                   snap)
        assert all(int(s.length.max()) == 0 for s in split.shards)
        with pytest.raises(NotImplementedError,
                           match="only through BatchEngine"):
            split.policy.prefill_chunk(split,
                                       *_kv(np.random.default_rng(0), 16))
    eng = Engine(model, graph=False, mesh=mesh)
    prompt = torch.zeros((1, 8), dtype=torch.long)
    cache = eng.shard_cache(model.init_cache(1, S_MAX, ragged=True),
                            allow_split_k=True)
    toks, _, stats = eng.generate_spec(params, prompt, cache, 4, spec_k=2)
    assert toks.shape == (1, 4) and stats["passes"] > 0
    cache = eng.shard_cache(model.init_cache(1, S_MAX, ragged=True),
                            allow_split_k=True)
    eng.prefill(params, prompt, cache)
    before = [t.clone() for _, t in pt.flatten_with_path(
        sc.gather_state(cache["attn"][0])) if isinstance(t, torch.Tensor)]
    st = cache["attn"][0]
    with pytest.raises(NotImplementedError, match="only through BatchEngine"):
        st.policy.prefill_chunk(st, *_kv(np.random.default_rng(1), 16))
    after = [t for _, t in pt.flatten_with_path(
        sc.gather_state(cache["attn"][0])) if isinstance(t, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
