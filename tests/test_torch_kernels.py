"""Port parity for the modules that hold kernels, on the CPU (where each
wrapper runs its kernel's plain version): B3 (fused rotate + quantize +
pack) and the int4 cache write, B1 (int4 flash-decode read) and the int4
``attend`` under GATHER and KERNEL.  Inputs are made with numpy from a
seed and go through the JAX function (Pallas kernels in interpret mode,
the default off-TPU) and its port."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kvcache as jkv  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import transforms as jtf  # noqa: E402
from repro.core.quant_attention_ref import decode_attention_quant  # noqa: E402
from repro.kernels.quant_attention.ops import (  # noqa: E402
    decode_attention_kernel as jdecode_kernel,
)
from repro.kernels.quant_attention.quant_attention import (  # noqa: E402
    quant_decode_attention_fwd,
)
from repro.kernels.srft_quant import ref as jref  # noqa: E402
from repro.kernels.srft_quant.srft_quant import srft_quant_fwd  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import kvcache, packing  # noqa: E402
from repro_torch.core.cache_api import AttendBackend, get_policy  # noqa: E402
from repro_torch.core.transforms import Rotation  # noqa: E402
from repro_torch.kernels.quant_attention import ref as qa_ref  # noqa: E402
from repro_torch.kernels.quant_attention.ops import (  # noqa: E402
    quant_decode_attention,
)
from repro_torch.kernels.srft_quant import ops as sq_ops  # noqa: E402
from repro_torch.kernels.srft_quant.ref import fold_matrix  # noqa: E402

# Codes may differ by +-1 only where y/scale lies within this distance of
# a .5 boundary (the two frameworks sum the d-term rotation in different
# orders, ~1e-6 relative); at most this share of all codes may flip.
TIE_BAND = 1e-4
MAX_FLIP_SHARE = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _jrot(d, seed, lam=True):
    r = jtf.make_rotation("srft", jax.random.PRNGKey(seed), d)
    if lam:
        lam_v = np.exp(0.3 * np.random.default_rng(seed).standard_normal(d))
        r = jtf.Rotation(r.matrix, jnp.asarray(lam_v, jnp.float32), r.signs,
                         r.kind)
    return r


def _trot(jrot):
    return Rotation(_t(jrot.matrix), _t(jrot.lam), _t(jrot.signs), jrot.kind)


def _codes(packed, bits):
    p = torch.from_numpy(np.array(packed))
    return (packing.unpack_int4(p) if bits == 4 else p).numpy().astype(
        np.int32)


def assert_codes_match(got, ref, y_exact, scales, *, group, bits=4):
    """Codes equal except +-1 flips at .5 boundaries of y/scale (float64)."""
    cg, cr = _codes(got, bits), _codes(ref, bits)
    diff = cg - cr
    assert np.abs(diff).max(initial=0) <= 1
    ratio = y_exact / np.repeat(np.asarray(scales, np.float64), group, -1)
    near_tie = np.abs(np.abs(ratio) % 1.0 - 0.5) < TIE_BAND
    flips = diff != 0
    assert not np.any(flips & ~near_tie), "a code flipped away from a tie"
    assert flips.mean() <= MAX_FLIP_SHARE, f"{flips.sum()} flips"


SQ_SWEEP = [(64, 32, 4, 128), (128, 32, 4, 200), (128, 16, 8, 64),
            (256, 32, 4, 64), (112, 28, 4, 64)]


@pytest.mark.parametrize("d,group,bits,n", SQ_SWEEP)
def test_b3_plain_matches_reference_and_interpret_kernel(d, group, bits, n):
    """Folded matrix, the reference kernel's own signature.  Scales: fp32
    rounding of the same absmax (rtol 1e-6); codes per TIE_BAND."""
    jrot = _jrot(d, d + group + bits)
    x = np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)
    m = np.asarray(jref.fold_matrix(jrot))
    got_p, got_s = sq_ops.srft_quant(_t(x), _t(m), group=group, bits=bits)
    ref_p, ref_s = jref.srft_quant_ref(jnp.asarray(x), jnp.asarray(m),
                                       group=group, bits=bits)
    tile = n if n % 64 else 64
    krn_p, krn_s = srft_quant_fwd(jnp.asarray(x), jnp.asarray(m), group=group,
                                  bits=bits, row_tile=tile)
    y = x.astype(np.float64) @ m.astype(np.float64).T
    for p, s in ((ref_p, ref_s), (krn_p, krn_s)):
        np.testing.assert_allclose(got_s.numpy(), np.asarray(s), rtol=1e-6)
        assert_codes_match(got_p.numpy(), p, y, s, group=group, bits=bits)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b3_cache_order_matches_reference_cache_write(dtype):
    """Unfolded matrix + lambda epilogue = ``rot.forward`` then per-group
    quantize, the order of the reference cache (kvcache.py:184-188)."""
    d, g = 128, 32
    jrot = _jrot(d, 11)
    x = np.random.default_rng(2).standard_normal((3, 5, 40, d)).astype(
        np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = bridge.to_torch(np.asarray(xj))
    got_p, got_s = sq_ops.rotate_quantize(xt, _trot(jrot), group=g)
    assert got_p.shape == (3, 5, 40, d // 2) and got_s.shape == (3, 5, 40, 4)
    y = jrot.forward(xj)
    q = jquant.quantize_per_group(y, 4, g)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(q.scales), rtol=1e-6)
    y64 = (np.asarray(xj.astype(jnp.float32), np.float64)
           @ np.asarray(jrot.matrix, np.float64).T) * np.asarray(jrot.lam)
    assert_codes_match(got_p.numpy(), jkv._quantize_rotated(y, g)[0], y64,
                       q.scales, group=g)


def test_b3_flush_mode_is_quantize_only_and_bit_exact():
    """No matrix: the W-flush path quantizes already-rotated values; no
    rotation sum is involved, so codes and scales are bit-exact."""
    y = np.random.default_rng(3).standard_normal((2, 4, 16, 64)).astype(
        np.float32)
    got_p, got_s = sq_ops.quantize_rotated(_t(y), group=32)
    ref_p, ref_s = jkv._quantize_rotated(jnp.asarray(y), 32)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


def test_fold_matrix_matches_reference():
    jrot = _jrot(64, 5)
    np.testing.assert_array_equal(fold_matrix(_trot(jrot)).numpy(),
                                  np.asarray(jref.fold_matrix(jrot)))


# --------------------------------------------------------------------- B1

def _b1_inputs(seed, BH, G, d, S, W, group):
    rng = np.random.default_rng(seed)
    return dict(
        q_eff=rng.standard_normal((BH, G, d)).astype(np.float32) * 0.3,
        k_packed=rng.integers(0, 256, (BH, S, d // 2)).astype(np.uint8),
        k_scales=rng.uniform(0.05, 0.5, (BH, S, d // group)).astype(
            np.float32),
        v_packed=rng.integers(0, 256, (BH, S, d // 2)).astype(np.uint8),
        v_scales=rng.uniform(0.05, 0.5, (BH, S, d // group)).astype(
            np.float32),
        k_residual=rng.standard_normal((BH, W, d)).astype(np.float32),
        v_residual=rng.standard_normal((BH, W, d)).astype(np.float32),
    )


# per-row (packed_len, total_len): an empty row (all masked: the finite
# garbage-mean of the reference), plen at a tile edge, plen mid-tile with
# a partial window, a full row with length % W == 0, plen = 0 with a
# residual-only prefix
B1_ROWS = [(0, 0), (32, 40), (48, 61), (96, 96), (0, 9)]


@pytest.mark.parametrize("d,G,group,blk", [(64, 2, 32, 32), (128, 2, 32, 16),
                                           (128, 4, 16, 32)])
def test_b1_plain_matches_interpret_kernel(d, G, group, blk):
    """Same tiles in the same order on both sides; atol 2e-5 covers the
    fp32 dot-product summation order (outputs are O(1))."""
    S, W = 96, 16
    BH = len(B1_ROWS)
    inp = _b1_inputs(d + G, BH, G, d, S, W, group)
    plen = np.array([r[0] for r in B1_ROWS], np.int32)
    tlen = np.array([r[1] for r in B1_ROWS], np.int32)
    ref = quant_decode_attention_fwd(
        *(jnp.asarray(v) for v in inp.values()), jnp.asarray(plen),
        jnp.asarray(tlen), group=group, blk=blk)
    got = quant_decode_attention(*(_t(v) for v in inp.values()), _t(plen),
                                 _t(tlen), group=group, blk=blk)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    # a scalar length is broadcast to every row
    got_s = quant_decode_attention(*(_t(v) for v in inp.values()), 48, 61,
                                   group=group, blk=blk)
    np.testing.assert_allclose(got_s.numpy()[2], got.numpy()[2], atol=1e-6)


def _jax_cache(seed, B, Hkv, S_max, d, prompt, n_dec, jrk, jrv, group=32):
    rng = np.random.default_rng(seed)
    cache = jkv.init_cache(B, Hkv, S_max, d, group=group, window=16)
    k = rng.standard_normal((B, Hkv, prompt, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, prompt, d)).astype(np.float32)
    cache = jkv.prefill(cache, jrk, jrv, jnp.asarray(k), jnp.asarray(v))
    steps = []
    update = jax.jit(jkv.decode_update)
    for _ in range(n_dec):
        kn = rng.standard_normal((B, Hkv, 1, d)).astype(np.float32)
        vn = rng.standard_normal((B, Hkv, 1, d)).astype(np.float32)
        cache = update(cache, jrk, jrv, jnp.asarray(kn), jnp.asarray(vn))
        steps.append((kn, vn))
    return cache, (k, v), steps


def _bridge_cache(jc):
    return kvcache.QuantKVCache(
        *(bridge.to_torch(np.asarray(getattr(jc, f))) for f in (
            "k_packed", "k_scales", "v_packed", "v_scales", "k_residual",
            "v_residual")),
        length=int(jc.length))


def test_kvcache_prefill_and_decode_update_bytes_match_reference():
    """Prompt of 37 (two packed slabs + 5 residual), then 30 appends: two
    W-flushes (at lengths 48 and 64).  Scales rtol 1e-6, residual window
    atol 1e-5 (rotation sums), codes per TIE_BAND."""
    B, Hkv, S_max, d, g = 2, 2, 96, 64, 32
    jrk, jrv = _jrot(d, 21), _jrot(d, 22)
    jc, (k, v), steps = _jax_cache(4, B, Hkv, S_max, d, 37, 30, jrk, jrv)
    rk, rv = _trot(jrk), _trot(jrv)
    tc = kvcache.init_cache(B, Hkv, S_max, d, group=g)
    kvcache.prefill(tc, rk, rv, _t(k), _t(v))
    for kn, vn in steps:
        kvcache.decode_update(tc, rk, rv, _t(kn), _t(vn))
    assert tc.length == int(jc.length) == 67
    assert kvcache.packed_len(tc) == int(jkv.packed_len(jc)) == 64

    def exact(rot, x):
        x64 = np.asarray(x, np.float64)
        return (x64 @ np.asarray(rot.matrix, np.float64).T) \
            * np.asarray(rot.lam)

    allk = np.concatenate([k] + [s[0] for s in steps], axis=2)[:, :, :64]
    allv = np.concatenate([v] + [s[1] for s in steps], axis=2)[:, :, :64]
    for side, rot, x in (("k", jrk, allk), ("v", jrv, allv)):
        scales = np.asarray(getattr(jc, f"{side}_scales"))[:, :, :64]
        np.testing.assert_allclose(
            getattr(tc, f"{side}_scales").numpy()[:, :, :64], scales,
            rtol=1e-6)
        assert_codes_match(
            getattr(tc, f"{side}_packed").numpy()[:, :, :64],
            np.asarray(getattr(jc, f"{side}_packed"))[:, :, :64],
            exact(rot, x), scales, group=g)
        np.testing.assert_allclose(
            getattr(tc, f"{side}_residual").numpy()[:, :, :3],
            np.asarray(getattr(jc, f"{side}_residual"))[:, :, :3], atol=1e-5)


@pytest.mark.parametrize("prompt,n_dec", [(37, 0), (48, 0), (40, 9),
                                          (5, 0)])
def test_int4_attend_gather_and_kernel_match_reference(prompt, n_dec):
    """On identical cache bytes (bridged): GATHER vs the reference GATHER,
    KERNEL (plain B1 on CPU) vs the reference's interpret-mode kernel, and
    the two port paths against each other.  atol 2e-5: fp32 softmax sums
    in another order; outputs are O(1).  Covers length % W == 0 (48) and
    an all-residual prefix (5)."""
    B, Hkv, Hq, S_max, d = 2, 2, 4, 96, 64
    jrk, jrv = _jrot(d, 31), _jrot(d, 32)
    jc, _, _ = _jax_cache(5, B, Hkv, S_max, d, prompt, n_dec, jrk, jrv)
    pol = get_policy("int4-srft")
    state = pol.with_rotations(pol.init_state(B, Hkv, S_max, d, device="cpu"),
                               _trot(jrk),
                               _trot(jrv))
    state.data.kv = _bridge_cache(jc)
    q = np.random.default_rng(6).standard_normal((B, Hq, 1, d)).astype(
        np.float32)
    ref_g = np.asarray(decode_attention_quant(jnp.asarray(q), jc, jrk, jrv))
    ref_k = np.asarray(jdecode_kernel(jnp.asarray(q), jc, jrk, jrv, blk=32))
    got_g = pol.attend(_t(q), state, backend=AttendBackend.GATHER).numpy()
    got_k = pol.attend(_t(q), state, backend="kernel", kv_block=32).numpy()
    np.testing.assert_allclose(got_g, ref_g, atol=2e-5)
    np.testing.assert_allclose(got_k, ref_k, atol=2e-5)
    np.testing.assert_allclose(got_k, got_g, atol=2e-5)


def test_kernel_backend_refuses_sliding_window_and_bf16_refuses_kernel(
        monkeypatch):
    """B1/B2 do not implement ``sliding_window``: a KERNEL read with one
    warns once per process and is served by BLOCKWISE (the reference's
    fallback, ``repro/core/cache_api.py:968-983``), with BLOCKWISE's
    result; bf16 still refuses KERNEL."""
    import warnings

    from repro_torch.core import cache_api

    monkeypatch.setattr(cache_api, "_KERNEL_SLIDING_WINDOW_WARNED", False)
    pol = get_policy("int4-srft")
    state = pol.init_state(1, 1, 32, 64, device="cpu", ragged=True)
    rng = np.random.default_rng(3)
    k, v = (_t(rng.standard_normal((1, 1, 21, 64)).astype(np.float32))
            for _ in "kv")
    pol.prefill(state, k, v)
    q = _t(rng.standard_normal((1, 2, 1, 64)).astype(np.float32))
    with pytest.warns(RuntimeWarning, match="BLOCKWISE"):
        got = pol.attend(q, state, backend="kernel", sliding_window=8,
                         kv_block=16)
    want = pol.attend(q, state, backend="blockwise", sliding_window=8,
                      kv_block=16)
    assert torch.equal(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once: the second read is silent
        again = pol.attend(q, state, backend=AttendBackend.KERNEL,
                           sliding_window=8, kv_block=16)
    assert torch.equal(again, want)
    bf = get_policy("bf16")
    with pytest.raises(NotImplementedError):
        bf.attend(q, bf.init_state(1, 1, 32, 64, device="cpu"),
                  backend="kernel")


def test_b1_plain_row_lengths_broadcast():
    assert qa_ref.row_lengths(7, 3, "cpu").tolist() == [7, 7, 7]
    assert qa_ref.row_lengths(torch.tensor([1, 2]), 2, "cpu").tolist() == [1, 2]


@pytest.mark.parametrize("source,ops", [("quant_attention", "qa"),
                                        ("srft_quant", "sq")])
def test_ctypes_argtypes_match_the_c_signatures(source, ops):
    """Every bound launch function's ``argtypes`` has one entry per
    parameter of its ``extern "C"`` definition, a pointer where the C
    parameter is a pointer and an int where it is an int (a missing entry
    shifts every later argument, the stream included)."""
    import ctypes
    import re
    from pathlib import Path

    from repro_torch.kernels.quant_attention import ops as qa_ops_mod

    argtypes = (qa_ops_mod if ops == "qa" else sq_ops).ARGTYPES
    src = (Path(qa_ops_mod.__file__).resolve().parents[1] / "csrc"
           / f"{source}.cu").read_text()
    extern = src[src.index('extern "C" {'):]
    for name, types in argtypes.items():
        m = re.search(rf"\bint {name}\(([^)]*)\)", extern)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params]
        assert types == kinds, f"{name}: {len(types)} argtypes for " \
                               f"{len(params)} parameters"


# (G, d, group) -> whether B1/B2's pass 1 runs on the tensor cores: the
# served shapes (internlm2-1.8b, qwen3-14b, dbrx-132b, llava-next-34b,
# qwen1.5-110b, qwen3-moe's 16 heads a KV head, smol-d64 and smol-d256)
# do; one head a KV head (gemma-7b, whisper) and zamba2-7b's d 112 with
# group 28 keep the first pass 1, as do groups that split a 32-channel block
@pytest.mark.parametrize("G,d,group,tc", [
    (2, 128, 32, True), (5, 128, 32, True), (6, 128, 32, True),
    (7, 128, 32, True), (8, 128, 32, True), (16, 128, 32, True),
    (2, 64, 32, True), (4, 256, 32, True), (2, 128, 64, True),
    (1, 256, 32, False), (1, 64, 32, False), (1, 128, 32, False),
    (2, 112, 28, False), (1, 112, 28, False), (2, 128, 16, False),
    (4, 48, 16, False), (2, 96, 32, True),
])
def test_tensor_core_pass_is_chosen_by_shape(G, d, group, tc):
    from repro_torch.kernels.quant_attention import ops as qa_ops_mod

    assert qa_ops_mod.tensor_core_pass(G, d, group) is tc


def test_tensor_core_pass_rule_equals_the_kernels():
    """ops.tensor_core_pass and csrc's tensor_core_pass state one rule:
    the C function's return expression, spelled in Python, is the
    wrapper's."""
    import inspect
    import re
    from pathlib import Path

    from repro_torch.kernels.quant_attention import ops as qa_ops_mod

    src = (Path(qa_ops_mod.__file__).resolve().parents[1] / "csrc"
           / "quant_attention.cu").read_text()
    m = re.search(r"bool tensor_core_pass\(int G, int d, int group\) \{\s*"
                  r"return ([^;]*);", src)
    assert m
    c_rule = " ".join(m.group(1).replace("&&", "and").split())
    py = inspect.getsource(qa_ops_mod.tensor_core_pass)
    py_rule = " ".join(py[py.rindex("return ") + 7:].split())
    assert c_rule == py_rule, (c_rule, py_rule)
