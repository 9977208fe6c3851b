"""The port's hand-written kernels on the card, each against its plain
PyTorch version on the same CUDA tensors.  Marked ``cuda``: skips where
no card is visible (the CPU tests hold the plain versions against the
JAX reference).  On the card: ``python -m pytest -q tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import kvcache, packing  # noqa: E402
from repro_torch.core.cache_api import get_policy  # noqa: E402
from repro_torch.core.transforms import make_rotation  # noqa: E402
from repro_torch.kernels.quant_attention import ops as qa_ops  # noqa: E402
from repro_torch.kernels.quant_attention import ref as qa_ref  # noqa: E402
from repro_torch.kernels.srft_quant import ops as sq_ops  # noqa: E402
from repro_torch.kernels.srft_quant import ref as sq_ref  # noqa: E402

pytestmark = pytest.mark.cuda

TIE_BAND = 1e-4  # codes may flip by 1 only this close to a .5 boundary
B1_ATOL = 1e-4  # fp32 sums in another order (split-K); outputs are O(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("d,group,bits,n,dtype,mode", [
    (128, 32, 4, 1000, torch.bfloat16, "rotate"),
    (128, 32, 4, 128, torch.float32, "flush"),
    (64, 16, 4, 33, torch.float32, "rotate"),
    (256, 32, 8, 70, torch.float32, "rotate"),
    (112, 28, 4, 65, torch.bfloat16, "folded"),
])
def test_b3_kernel_matches_plain(dev, d, group, bits, n, dtype, mode):
    g = _gen(dev, d + n)
    rot = make_rotation("srft", g, d, dev)
    rot.lam = torch.exp(0.3 * torch.randn(d, generator=g, device=dev))
    x = torch.randn((n, d), generator=g, device=dev).to(dtype)
    mat, lam = {"rotate": (rot.matrix, rot.lam), "flush": (None, None),
                "folded": (sq_ref.fold_matrix(rot), None)}[mode]
    before = sq_ops.launches
    kp, ks = sq_ops.srft_quant(x, mat, lam, group=group, bits=bits)
    assert sq_ops.launches == before + 1
    rp, rs = sq_ref.srft_quant_ref(x, mat, lam, group=group, bits=bits)
    torch.cuda.synchronize()
    torch.testing.assert_close(ks, rs, rtol=1e-6, atol=0)
    unpack = packing.unpack_int4 if bits == 4 else (lambda t: t)
    diff = unpack(kp).int() - unpack(rp).int()
    y = x.double() if mat is None else x.double() @ mat.double().T
    if lam is not None:
        y = y * lam.double()
    ratio = y / rs.double().repeat_interleave(group, dim=-1)
    near_tie = ((ratio.abs() % 1.0) - 0.5).abs() < TIE_BAND
    assert int(diff.abs().max()) <= 1
    assert not bool(((diff != 0) & ~near_tie).any())


def _b1_args(dev, seed, BH, G, d, S, W, group):
    g = _gen(dev, seed)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    def f(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    return (f(BH, G, d, scale=0.2), u8(BH, S, d // 2),
            f(BH, S, d // group).abs() * 0.3, u8(BH, S, d // 2),
            f(BH, S, d // group).abs() * 0.3, f(BH, W, d), f(BH, W, d))


@pytest.mark.parametrize("d,G,group,S", [(128, 2, 32, 4608), (64, 2, 32, 200),
                                         (256, 4, 32, 129), (128, 1, 16, 64),
                                         (112, 8, 28, 300)])
def test_b1_kernel_matches_plain_per_row(dev, d, G, group, S):
    W = 16
    cand = [0, 64, 65, S // 2, S - S % W, 16, S - 1, 1]
    plen = torch.tensor(cand, dtype=torch.int32, device=dev).clamp(max=S)
    extra = torch.tensor([0, 0, 3, 15, 1, 9, 0, 5], device=dev)
    tlen = (plen + extra).int()
    args = _b1_args(dev, d + S, len(cand), G, d, S, W, group)
    got = qa_ops.quant_decode_attention(*args, plen, tlen, group=group)
    want = qa_ref.quant_decode_attention_ref(*args, plen, tlen, group=group)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=B1_ATOL, rtol=0)


@pytest.mark.parametrize("plen,tlen", [(0, 0), (0, 7), (64, 64), (4096, 4101),
                                       (4592, 4607)])
def test_b1_kernel_matches_plain_scalar_lengths(dev, plen, tlen):
    args = _b1_args(dev, plen, 8, 2, 128, 4608, 16, 32)
    got = qa_ops.quant_decode_attention(*args, plen, tlen, group=32)
    want = qa_ref.quant_decode_attention_ref(*args, plen, tlen, group=32)
    torch.testing.assert_close(got, want, atol=B1_ATOL, rtol=0)


def test_int4_cache_kernel_read_matches_gather_on_card(dev):
    """A cache written by B3 (prefill + two W-flushes) read through B1
    equals the GATHER read of the same bytes."""
    B, Hkv, Hq, S_max, d = 1, 8, 16, 256, 128
    pol = get_policy("int4-srft")
    state = pol.init_state(B, Hkv, S_max, d, device=dev,
                           generator=torch.Generator().manual_seed(0))
    g = _gen(dev, 9)
    k = torch.randn((B, Hkv, 150, d), generator=g, device=dev)
    pol.prefill(state, k.bfloat16(), k.bfloat16())
    for _ in range(40):
        kn = torch.randn((B, Hkv, 1, d), generator=g, device=dev)
        pol.update(state, kn, kn)
    assert kvcache.packed_len(state.data.kv) == 176
    q = torch.randn((B, Hq, 1, d), generator=g, device=dev)
    got = pol.attend(q, state, backend="kernel")
    want = pol.attend(q, state, backend="gather")
    torch.testing.assert_close(got, want, atol=B1_ATOL, rtol=0)
