"""The port's hand-written kernels on the card, each against its plain
PyTorch version on the same CUDA tensors, B4 on codes B3 wrote, and B2
(paged) against B1 (dense) on the gathered view, bitwise; the int4
``raw_kv_view`` through B4 against the CPU's, chunked admission against
monolithic admission, a BLOCKWISE read replayed from a CUDA graph, and
speculative decoding (a captured verify pass against the eager one, also
across a flush boundary; spec == plain streams; the launches of a pass),
a cache sharded by head over a (1, 2) mesh of the card (graph ==
eager == unsharded, streams and cache bytes), B1's optional log-sum-exp
against its plain version's, and a split-K cache over a (1, 3) mesh of
the card (graph == eager, streams against the unsharded run).
Marked ``cuda``: skips where no card is visible (the CPU tests hold the
plain versions against the JAX reference).  On the card: ``python -m
pytest -q tests/test_torch_cuda.py``.
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


# the product's tile edges (32-row tiles at d 128 / 256, 64 at d 64) up to
# the prefill write's 32,640 rows; the no-matrix route at the W-flush's 128
# rows, the batch ring's 512, d 256 and group 16; bits 4 and 8; bf16 and
# fp32 input; the generic routes (d 112, group 28); the served writes of
# zamba2-7b (65,536 rows x d 112, bf16) and whisper-large-v3 (30,000 x 64)
B3_CASES = [
    (112, 28, 4, 65536, torch.bfloat16, "rotate"),
    (64, 32, 4, 30000, torch.bfloat16, "rotate"),
    (128, 32, 4, 1000, torch.bfloat16, "rotate"),
    (128, 32, 4, 128, torch.float32, "flush"),
    (64, 16, 4, 33, torch.float32, "rotate"),
    (256, 32, 8, 70, torch.float32, "rotate"),
    (112, 28, 4, 65, torch.bfloat16, "folded"),
    (128, 32, 4, 1, torch.bfloat16, "rotate"),
    (128, 32, 4, 63, torch.bfloat16, "rotate"),
    (128, 32, 8, 64, torch.float32, "rotate"),
    (128, 32, 4, 65, torch.float32, "folded"),
    (128, 32, 4, 4096, torch.bfloat16, "rotate"),
    (128, 32, 4, 32640, torch.bfloat16, "rotate"),
    (64, 64, 8, 65, torch.bfloat16, "rotate"),
    (128, 32, 4, 512, torch.float32, "flush"),
    (256, 16, 4, 128, torch.float32, "flush"),
    (64, 64, 8, 33, torch.bfloat16, "flush"),
    (128, 32, 8, 1, torch.float32, "flush"),
    (112, 28, 4, 128, torch.float32, "flush"),
    (112, 28, 8, 33, torch.float32, "rotate"),
]


@pytest.mark.parametrize("d,group,bits,n,dtype,mode", B3_CASES)
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


def _gamma(n: int, u: float) -> float:
    """Higham's gamma_n = n u / (1 - n u): the relative forward-error
    bound of n rounded operations in a row."""
    return n * u / (1 - n * u)


def test_b3_scales_at_d256_within_the_fp32_sum_bound(dev):
    """d 256, group 16, 33 rows, bf16 in, with a matrix (ROADMAP C1).  At
    this shape the plain version's product (cuBLAS) sums in another order
    than the kernel's k-order FMAs, and one scale missed the rtol-1e-6
    gate; the scales are held instead to a float64 product rounded to
    fp32, within the forward-error bound of the kernel's arithmetic.

    With u = 2^-24 and A_j = sum_k |x_k M_jk| (x is exact in fp32):
      * 256 FMAs in a row: |acc_j - sum_j| <= gamma_256 A_j;
      * times lam_j, rounded: |y_j - lam_j sum_j| <= gamma_257 lam_j A_j;
      * the group absmax is exact, so it is off by at most
        E = gamma_257 max_j(lam_j A_j) over the group;
      * the division by 7 rounds once: (E + u absmax) / 7;
      * the reference rounds the float64 scale s to fp32: u s, and the
        float64 product is itself off by gamma_257 (u = 2^-53) lam_j A_j.
    The codes are then held to the plain version's as in the other
    cases."""
    d, group, n = 256, 16, 33
    g = _gen(dev, d + n)
    rot = make_rotation("srft", g, d, dev)
    rot.lam = torch.exp(0.3 * torch.randn(d, generator=g, device=dev))
    x = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
    kp, ks = sq_ops.srft_quant(x, rot.matrix, rot.lam, group=group, bits=4)
    rp, rs = sq_ref.srft_quant_ref(x, rot.matrix, rot.lam, group=group,
                                   bits=4)
    torch.cuda.synchronize()
    x64, m64, lam64 = x.double(), rot.matrix.double(), rot.lam.double()
    y = (x64 @ m64.T) * lam64
    a = (x64.abs() @ m64.abs().T) * lam64
    by_group = (n, d // group, group)
    s = y.abs().reshape(by_group).amax(-1).clamp_min(1e-12) / 7
    e = a.reshape(by_group).amax(-1)
    u32, u64 = 2.0 ** -24, 2.0 ** -53
    bound = ((_gamma(257, u32) * e + u32 * (s * 7 + _gamma(257, u32) * e))
             / 7 + u32 * s + _gamma(257, u64) * e / 7)
    err = (ks.double() - s.float().double()).abs()
    assert (err <= bound).all(), (err / bound).max().item()
    diff = packing.unpack_int4(kp).int() - packing.unpack_int4(rp).int()
    ratio = y / rs.double().repeat_interleave(group, dim=-1)
    near_tie = ((ratio.abs() % 1.0) - 0.5).abs() < TIE_BAND
    assert int(diff.abs().max()) <= 1
    assert not bool(((diff != 0) & ~near_tie).any())


@pytest.mark.parametrize("d,group,bits,n", [
    (128, 32, 4, 32640), (64, 32, 4, 1000), (64, 16, 8, 33),
    (256, 32, 4, 70), (256, 32, 8, 513), (112, 28, 4, 65),
    (128, 32, 4, 1), (128, 32, 4, 63), (128, 32, 8, 64), (128, 32, 4, 65),
    (128, 32, 4, 4096), (64, 16, 4, 129), (112, 28, 8, 33),
    (128, 32, 4, 8192),  # the raw view of a reused 1,024-token prefix
])
def test_b4_kernel_matches_plain(dev, d, group, bits, n):
    """B4 on the codes of the folded B3 write: max abs error within 1e-5
    of max(1, max |x|) (fp32 sums of d terms in another order; lambda
    inflates the outputs), and the round trip within the reference
    test's bound."""
    g = _gen(dev, d + n + bits)
    rot = make_rotation("srft", g, d, dev)
    rot.lam = torch.exp(0.3 * torch.randn(d, generator=g, device=dev))
    x = torch.randn((n, d), generator=g, device=dev)
    pk, sc = sq_ops.srft_quant(x, sq_ref.fold_matrix(rot), group=group,
                               bits=bits)
    minv = sq_ref.fold_inverse_matrix(rot)
    before = sq_ops.dequant_launches
    got = sq_ops.srft_dequant(pk, sc, minv, group=group, bits=bits)
    assert sq_ops.dequant_launches == before + 1
    want = sq_ref.srft_dequant_ref(pk, sc, minv, group=group, bits=bits)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (n, d)
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    rt = sq_ops.dequantize_rotate(pk, sc, rot, group=group, bits=bits)
    assert torch.equal(rt, got)
    assert (rt - x).abs().max().item() < (1.5 if bits == 4 else 0.1)


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


# the shapes the hybrid and the audio family serve: zamba2-7b's shared
# block (32 KV heads, G 1, d 112, group 28: words straddle groups) over a
# 2048-token prompt and its decode, and whisper-large-v3's cross cache (20
# heads, G 1, d 64) over 1500 frames: 1488 packed, 12 in the window
SERVED_SHAPES = [(32, 112, 28, 2096, 2064, 2079),
                 (20, 64, 32, 1520, 1488, 1500)]


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("BH,d,group,S,plen,tlen", SERVED_SHAPES)
def test_b1_kernel_matches_plain_at_the_served_shapes(dev, BH, d, group, S,
                                                     plen, tlen, per_row):
    args = _b1_args(dev, d + S, BH, 1, d, S, 16, group)
    if per_row:  # a cache that keeps its lengths on the device
        plen = torch.full((BH,), plen, dtype=torch.int32, device=dev)
        tlen = torch.full((BH,), tlen, dtype=torch.int32, device=dev)
    before = qa_ops.launches
    got = qa_ops.quant_decode_attention(*args, plen, tlen, group=group)
    assert qa_ops.launches == before + 1
    want = qa_ref.quant_decode_attention_ref(*args, plen, tlen, group=group)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=B1_ATOL, rtol=0)


# packed lengths at the edges of a warp's tokens and of the 64-token tile:
# a warp, or a token slot within it, with no live token must add no
# probability mass.  At S = 160 a split holds one tile (4 warps of 16
# tokens), at S = 4096 two (8 warps of 8 tokens).
EDGES = (1, 15, 16, 17, 31, 33, 47, 48, 63, 64, 65)


@pytest.mark.parametrize("S", [160, 4096])
@pytest.mark.parametrize("d,G,group", [(128, 2, 32), (112, 2, 28),
                                       (64, 4, 16), (256, 8, 32)])
def test_b1_kernel_matches_plain_at_warp_and_tile_edges(dev, d, G, group, S):
    W = 16
    plen = torch.tensor(EDGES, dtype=torch.int32, device=dev)
    extra = torch.tensor([0, 3, 1, 16, 5, 0, 2, 9, 1, 4, 7], device=dev)
    args = _b1_args(dev, d + G, len(EDGES), G, d, S, W, group)
    got = qa_ops.quant_decode_attention(*args, plen, (plen + extra).int(),
                                        group=group)
    want = qa_ref.quant_decode_attention_ref(*args, plen, plen + extra,
                                             group=group)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=B1_ATOL, rtol=0)


# every head dim the lane mapping handles differently (the tokens a warp
# step scores change with d and G; d = 112 leaves lanes of a slot idle) by
# every group that divides it (group 28 straddles words) by G = 1, 2, 4, 8,
# the served configs' 5, 6, 7 (the 8-head code with idle heads) and 16
# (two head groups of the 8-head code)
B1_SHAPES = [(d, group, G)
             for d, groups in ((64, (16, 32, 64)), (112, (16, 28)),
                               (128, (16, 32, 64)), (256, (16, 32, 64)))
             for group in groups for G in (1, 2, 4, 5, 6, 7, 8, 16)]


@pytest.mark.parametrize("d,group,G", B1_SHAPES)
def test_b1_kernel_matches_plain_across_shapes(dev, d, group, G):
    W, S = 16, 300
    plen = torch.tensor([0, 77, 200, S], dtype=torch.int32, device=dev)
    tlen = (plen + torch.tensor([5, 16, 2, 0], device=dev)).int()
    args = _b1_args(dev, d * G + group, 4, G, d, S, W, group)
    got = qa_ops.quant_decode_attention(*args, plen, tlen, group=group)
    want = qa_ref.quant_decode_attention_ref(*args, plen, tlen, group=group)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=B1_ATOL, rtol=0)


def test_b1_and_b2_refuse_more_than_16_heads_per_kv_head(dev):
    """G = 17 (above the two head groups of 8) raises, naming the limit."""
    args = _b1_args(dev, 17, 2, 17, 128, 64, 16, 32)
    with pytest.raises(ValueError, match="1 to 16 query heads"):
        qa_ops.quant_decode_attention(*args, 48, 50, group=32)
    table = torch.ones((2, 4), dtype=torch.int32, device=dev)
    pool = [a.reshape(-1, 16, a.shape[-1])[:8] for a in args[1:5]]
    L = torch.full((2,), 50, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="1 to 16 query heads"):
        qa_ops.quant_decode_attention_paged(
            args[0], *pool, args[5], args[6], L - L % 16, L, table,
            group=32, page_size=16, n_kv_heads=1)


def test_moe_engine_graph_equals_eager_at_16_heads_per_kv_head(dev):
    """A reduced qwen3-moe with 16 query heads over 1 KV head (G = 16, B1's
    two head groups) decoding through its routed experts: the captured
    step equals the eager loop (tokens up to a near-tie, logits within
    1e-5 of the largest), and a replay launches B1 once and B3 twice a
    layer."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.engine import GRAPH_KEY, Engine
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(reduced(get_config("qwen3-moe-235b-a22b")),
                              n_heads=16, n_kv_heads=1)
    model = LM(cfg, device=dev)
    params = model.init(model.generator(0))
    prompt = torch.randint(0, cfg.vocab_size, (1, 47),
                           generator=torch.Generator().manual_seed(1)).cuda()
    out = {}
    for graph in (False, True):
        cache = model.init_cache(1, 128, policy="int4-srft", ragged=True,
                                 generator=torch.Generator().manual_seed(3))
        eng = Engine(model, backend="kernel", graph=graph)
        toks, lg, cache = eng.generate(params, prompt, cache, 24,
                                       return_logits=True)
        out[graph] = (toks.cpu(), lg.cpu(), cache)
    (t_e, l_e, _), (t_g, l_g, cache) = out[False], out[True]
    assert torch.isfinite(l_g).all()
    diff = (t_e != t_g).nonzero()
    n = t_e.shape[1]
    if len(diff):
        n = int(diff[:, 1].min()) + 1
        top2 = l_e[0, n - 1].topk(2).values
        assert (top2[0] - top2[1]).item() < 0.05 * l_e.abs().max().item()
    err = (l_g[:, :n] - l_e[:, :n]).abs().max().item()
    assert err <= 1e-5 * l_e.abs().max().item(), err
    assert cache[GRAPH_KEY].step.counts == (cfg.n_layers, 0,
                                            2 * cfg.n_layers, 0)


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


def _b2_case(dev, seed, lengths, H, G, d, group, ps, s_max, W=16):
    """Random pools behind a shuffled page table (rows of length 0 map
    nothing), per-row windows and per-(b, h) lengths."""
    g = _gen(dev, seed)
    gc = torch.Generator().manual_seed(seed)
    MP = s_max // ps
    need = [-(-n // ps) for n in lengths]
    n_pages = sum(need) + 2
    perm = (torch.randperm(n_pages - 1, generator=gc) + 1).tolist()
    table = torch.zeros((len(lengths), MP), dtype=torch.int32)
    for b, n in enumerate(need):
        table[b, :n] = torch.tensor([perm.pop() for _ in range(n)])
    N, BH = n_pages * H, len(lengths) * H

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    def f(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    args = (f(BH, G, d, scale=0.2), u8(N, ps, d // 2),
            f(N, ps, d // group).abs() * 0.3, u8(N, ps, d // 2),
            f(N, ps, d // group).abs() * 0.3, f(BH, W, d), f(BH, W, d))
    L = torch.tensor(lengths, dtype=torch.int32, device=dev
                     ).repeat_interleave(H)
    return args, (L - L % W).int(), L, table.to(dev)


# (lengths, H, G, d, group, page_size, s_max): small shapes, pages smaller
# than, equal to and larger than the 64-token tile, pages of 48 and 80 that
# neither divide nor are a multiple of it (tiles span page boundaries; rows
# end inside a page), and the main path's (internlm2-1.8b: 8 kv heads, G=2,
# d=128; rows of 517..4093 tokens and a retired row) at pages of 16 and 48
B2_CASES = [
    ((0, 15, 37, 200), 2, 2, 64, 32, 16, 256),
    ((5, 64, 130, 255), 2, 4, 128, 16, 32, 256),
    ((0, 100, 1000), 4, 2, 128, 32, 64, 1024),
    ((300, 17), 1, 8, 256, 32, 128, 512),
    ((517, 1031, 2055, 4093, 0), 8, 2, 128, 32, 16, 4608),
    ((0, 47, 49, 130, 300), 2, 2, 128, 32, 48, 336),
    ((0, 79, 81, 170, 639), 2, 4, 64, 16, 80, 640),
    ((517, 1031, 2055, 4093, 0), 8, 2, 128, 32, 48, 4608),
    # the served configs' grouping: gemma-7b (16 kv heads, G 1, d 256),
    # qwen3-14b (G 5), dbrx-132b (G 6), llava-next-34b (G 7, pages of 48),
    # qwen3-moe-235b-a22b (4 kv heads, G 16: two head groups)
    ((512, 2048, 2055, 1024, 0), 16, 1, 256, 32, 16, 2064),
    ((300, 1000, 17), 8, 5, 128, 32, 16, 1024),
    ((300, 1000, 17, 0), 8, 6, 128, 32, 16, 1024),
    ((300, 1000, 17), 8, 7, 128, 32, 48, 1056),
    ((512, 2048, 2055, 1024, 0), 4, 16, 128, 32, 16, 2064),
    # pages that do not hold whole 16-token steps (the tensor-core pass 1
    # looks each token's row up): 24 and 8 tokens
    ((0, 23, 100, 300), 2, 2, 128, 32, 24, 312),
    ((5, 130, 257), 2, 5, 128, 32, 8, 264),
]


@pytest.mark.parametrize("case", B2_CASES)
def test_b2_kernel_matches_plain_and_equals_b1(dev, case):
    lengths, H, G, d, group, ps, s_max = case
    args, plen, tlen, table = _b2_case(dev, sum(lengths), lengths, H, G, d,
                                       group, ps, s_max)
    kw = dict(group=group, page_size=ps, n_kv_heads=H)
    before = qa_ops.paged_launches
    before_tc = qa_ops.tc_launches
    got = qa_ops.quant_decode_attention_paged(*args, plen, tlen, table, **kw)
    assert qa_ops.paged_launches == before + 1
    tc = qa_ops.tensor_core_pass(G, d, group)
    assert qa_ops.tc_launches == before_tc + tc
    want = qa_ref.quant_decode_attention_paged_ref(
        *args, plen, tlen, table, group=group, n_kv_heads=H)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=B1_ATOL, rtol=0)
    # B1 on the gathered view (S = MP * page_size): the same bits
    q, kp, ks, vp, vs, kr, vr = args
    rows = [qa_ref.paged_rows(t, table, H).contiguous()
            for t in (kp, ks, vp, vs)]
    dense = qa_ops.quant_decode_attention(q, *rows, kr, vr, plen, tlen,
                                          group=group)
    assert torch.equal(got, dense)
    assert qa_ops.tc_launches == before_tc + 2 * tc


def _pass1_kernels(fn) -> set:
    """The names of the pass-1 kernels ``fn`` launches, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if "qda_split_kernel" in e.key}


# one layer of the benchmark's long-context cells (8 KV heads, d 128, group
# 32, pages of 16) at G 2 (internlm2-1.8b) and G 5 (qwen3-14b): rows of
# 2,048 to 10,000 tokens whose packed parts end mid-page and mid-tile, and
# one row shorter than a tile
@pytest.mark.parametrize("G", [2, 5])
def test_b2_at_the_long_cells_shapes_takes_the_tensor_cores(dev, G):
    lengths = (2048, 2061, 4133, 6001, 8190, 10000, 40)
    H, d, group, ps = 8, 128, 32, 16
    args, _, tlen, table = _b2_case(dev, 31 + G, lengths, H, G, d, group, ps,
                                    10016)
    plen = torch.tensor((2040, 2053, 4130, 5993, 8181, 9989, 37),
                        dtype=torch.int32, device=dev).repeat_interleave(H)
    kw = dict(group=group, page_size=ps, n_kv_heads=H)
    before = (qa_ops.paged_launches, qa_ops.tc_launches)
    call = lambda: qa_ops.quant_decode_attention_paged(  # noqa: E731
        *args, plen, tlen, table, **kw)
    got = call()
    assert (qa_ops.paged_launches, qa_ops.tc_launches) == (
        before[0] + 1, before[1] + 1)
    want = qa_ref.quant_decode_attention_paged_ref(
        *args, plen, tlen, table, group=group, n_kv_heads=H)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=B1_ATOL, rtol=0)
    q, kp, ks, vp, vs, kr, vr = args
    rows = [qa_ref.paged_rows(t, table, H).contiguous()
            for t in (kp, ks, vp, vs)]
    dense = qa_ops.quant_decode_attention(q, *rows, kr, vr, plen, tlen,
                                          group=group)
    assert torch.equal(got, dense)
    assert qa_ops.tc_launches == before[1] + 2
    names = _pass1_kernels(call)
    assert names and all("qda_split_kernel_tc" in k for k in names), names


# the shapes that keep the first pass 1: one head a KV head (gemma-7b's
# 16 x 1 x 256) and d 112 with group 28 (zamba2-7b's shared block)
@pytest.mark.parametrize("H,G,d,group", [(16, 1, 256, 32), (4, 2, 112, 28)])
def test_b1_b2_keep_the_first_pass_1_off_the_tensor_cores(dev, H, G, d,
                                                          group):
    lengths = (2055, 517, 0)
    args, plen, tlen, table = _b2_case(dev, d + G, lengths, H, G, d, group,
                                       16, 2064)
    kw = dict(group=group, page_size=16, n_kv_heads=H)
    assert not qa_ops.tensor_core_pass(G, d, group)
    before = qa_ops.tc_launches
    call = lambda: qa_ops.quant_decode_attention_paged(  # noqa: E731
        *args, plen, tlen, table, **kw)
    got = call()
    want = qa_ref.quant_decode_attention_paged_ref(
        *args, plen, tlen, table, group=group, n_kv_heads=H)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=B1_ATOL, rtol=0)
    q, kp, ks, vp, vs, kr, vr = args
    rows = [qa_ref.paged_rows(t, table, H).contiguous()
            for t in (kp, ks, vp, vs)]
    dense = qa_ops.quant_decode_attention(q, *rows, kr, vr, plen, tlen,
                                          group=group)
    assert torch.equal(got, dense)
    assert qa_ops.tc_launches == before
    names = _pass1_kernels(call)
    assert names and not any("qda_split_kernel_tc" in k for k in names), \
        names


def test_b2_pages_of_16_ending_mid_page_match_plain_and_b1(dev):
    """Packed lengths that end inside a 16-token page (and inside a warp's
    16 tokens), so a token's page lookup and copies stop mid-page."""
    lengths = (23, 47, 130, 250, 1001, 0)
    H, G, d, group, ps = 2, 2, 128, 32, 16
    args, _, tlen, table = _b2_case(dev, 15, lengths, H, G, d, group, ps,
                                    1024)
    plen = torch.tensor((7, 40, 129, 249, 993, 0), dtype=torch.int32,
                        device=dev).repeat_interleave(H)
    kw = dict(group=group, page_size=ps, n_kv_heads=H)
    got = qa_ops.quant_decode_attention_paged(*args, plen, tlen, table, **kw)
    want = qa_ref.quant_decode_attention_paged_ref(
        *args, plen, tlen, table, group=group, n_kv_heads=H)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=B1_ATOL, rtol=0)
    q, kp, ks, vp, vs, kr, vr = args
    rows = [qa_ref.paged_rows(t, table, H).contiguous()
            for t in (kp, ks, vp, vs)]
    dense = qa_ops.quant_decode_attention(q, *rows, kr, vr, plen, tlen,
                                          group=group)
    assert torch.equal(got, dense)


def test_paged_engine_equals_dense_engine_on_card(dev):
    """A small model served through both slot caches on the card: the int4
    KERNEL streams (B2 paged, B1 dense) are equal token for token."""
    from repro_torch.configs import get_config
    from repro_torch.launch.batch_engine import BatchEngine, Request
    from repro_torch.models.lm import LM

    model = LM(get_config("smol-d64"), device=dev)
    params = model.init(model.generator(0))
    g = torch.Generator().manual_seed(1)
    reqs = [Request(i, torch.randint(0, 256, (n,), generator=g).numpy(), m)
            for i, (n, m) in enumerate([(9, 8), (70, 20), (40, 33), (23, 12)])]
    out = {}
    for paged in (False, True):
        eng = BatchEngine(model, params, capacity=3, s_max=128,
                          policy="int4-srft", backend="kernel", chunk=4,
                          paged=paged, page_size=16)
        before = qa_ops.paged_launches
        out[paged] = {c.rid: c.tokens for c in eng.run(list(reqs))}
        assert (qa_ops.paged_launches > before) == paged
    for i in range(len(reqs)):
        assert (out[True][i] == out[False][i]).all(), i


def test_b1_after_b2_keeps_its_shared_memory(dev):
    """B1 and B2 share the combine pass, whose dynamic shared memory grows
    with the number of splits.  A B2 call that needs less must not lower
    the limit a later B1 call needs (batch 1 at 4608 tokens takes more
    than the default 48 KB).  In a fresh process: the limit is process
    state, so earlier tests must not decide the outcome."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = """
import torch
from repro_torch.kernels.quant_attention import ops
import test_torch_cuda as t
dev = torch.device("cuda")
args = t._b1_args(dev, 3, 8, 2, 128, 4608, 16, 32)
want = ops.quant_decode_attention(*args, 4096, 4101, group=32)
b2, plen, tlen, table = t._b2_case(dev, 4, (517, 1031, 2055, 4093, 0), 8, 2,
                                   128, 32, 16, 4608)
ops.quant_decode_attention_paged(*b2, plen, tlen, table, group=32,
                                 page_size=16, n_kv_heads=8)
got = ops.quant_decode_attention(*args, 4096, 4101, group=32)
torch.cuda.synchronize()
assert torch.equal(got, want)
"""
    here = Path(__file__).resolve().parent
    env_path = f"{here.parent / 'src'}:{here}"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": env_path})
    assert res.returncode == 0, res.stderr[-2000:]


def test_int4_raw_kv_view_on_card_matches_cpu(dev):
    """The int4 raw view of a reused 1,024-token prefix at internlm2's
    heads (8 x 1,024 = 8,192 rows of d 128 per leaf): B4 on the card, one
    launch per leaf, against the plain version on the CPU on the same
    bytes (fp32 sums in another order: within 1e-5 of max |x|)."""
    pol = get_policy("int4-srft")
    g = torch.Generator().manual_seed(11)
    cpu = pol.init_state(1, 8, 1040, 128, generator=g, device="cpu",
                         ragged=True)
    lam = torch.exp(0.3 * torch.randn(128, generator=g))
    rk, rv = cpu.data.rot_k, cpu.data.rot_v
    rk.lam, rv.lam = lam, lam.flip(0)
    k, v = (torch.randn((1, 8, 1031, 128), generator=g).bfloat16()
            for _ in "kv")
    pol.prefill(cpu, k, v)
    card = pol.init_state(1, 8, 1040, 128, device=dev, ragged=True)
    card = pol.with_rotations(card, *(
        type(r)(r.matrix.to(dev), r.lam.to(dev), r.signs.to(dev), r.kind)
        for r in (rk, rv)))
    for f in ("k_packed", "k_scales", "v_packed", "v_scales", "length"):
        getattr(card.data.kv, f).copy_(getattr(cpu.data.kv, f))
    before = sq_ops.dequant_launches
    got = pol.raw_kv_view(card, 1024)
    torch.cuda.synchronize()
    assert sq_ops.dequant_launches == before + 2
    for g_, w in zip(got, pol.raw_kv_view(cpu, 1024)):
        assert g_.shape == w.shape == (1, 8, 1024, 128)
        tol = 1e-5 * max(1.0, w.abs().max().item())
        assert (g_.cpu() - w).abs().max().item() <= tol


def _forced_logits(model, params, prompt, toks, rots, backend):
    """One request alone, teacher-forced on ``toks`` (eager): its logits
    at every step, for the near-tie rule."""
    cache = model.init_cache(1, 128, policy="int4-srft", rots=rots)
    lg, cache = model.prefill(
        params, torch.as_tensor(prompt, device=model.device)[None].long(),
        cache)
    out = [lg[0, -1].float()]
    for t in toks[:-1]:
        lg, cache = model.decode_step(
            params, torch.tensor([[int(t)]], device=model.device), cache,
            backend=backend)
        out.append(lg[0, -1].float())
    return torch.stack(out).cpu()


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_engine_equals_monolithic_on_card(dev, paged):
    """smol-d64 on the card, int4 KERNEL (B1 dense, B2 paged), the graph
    decode: chunked admission (chunks of 16, several quanta per prompt)
    gives the monolithic engine's streams, up to a near-tie (cuBLAS picks
    its product by shape, so a chunk's projections may round otherwise
    than the whole prompt's), and returns every page."""
    from repro_torch.configs import get_config
    from repro_torch.launch.batch_engine import BatchEngine, Request
    from repro_torch.models.lm import LM

    model = LM(get_config("smol-d64"), device=dev)
    params = model.init(model.generator(0))
    g = torch.Generator().manual_seed(2)
    reqs = [Request(i, torch.randint(0, 256, (n,), generator=g).numpy(), m)
            for i, (n, m) in enumerate([(9, 8), (70, 20), (40, 33), (23, 12)])]
    out, engs = {}, {}
    for pc in (None, 16):
        eng = BatchEngine(model, params, capacity=3, s_max=128,
                          policy="int4-srft", backend="kernel", chunk=4,
                          paged=paged, page_size=16, prefill_chunk=pc,
                          prefill_budget=pc)
        out[pc] = {c.rid: c.tokens for c in eng.run(list(reqs))}
        engs[pc] = eng
    assert engs[16].n_prefill_chunks == 1 + 5 + 3 + 2
    if paged:
        assert engs[16].pool_stats()["pages_used"] == 0
    for r in reqs:
        mono, ch = out[None][r.rid], out[16][r.rid]
        diff = (mono != ch).nonzero()[0]
        if len(diff):
            i = int(diff[0])
            lg = _forced_logits(model, params, r.prompt, mono,
                                engs[None]._rots, "kernel")
            top2 = lg[i].topk(2).values
            assert top2[0] - top2[1] < 0.05 * lg.abs().max(), (r.rid, i)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_blockwise_read_replayed_from_a_graph_equals_eager(dev, policy,
                                                           paged):
    """A BLOCKWISE read (a fixed number of tiles, no exit that depends on
    the data) captured in a ``StepGraph`` and replayed gives the eager
    read's bytes, on ragged lengths with an empty row; then the lengths
    change in place and a replay follows them."""
    from repro_torch.launch.graphs import StepGraph

    B, H, Hq, S, d = 3, 2, 4, 256, 64
    pol = get_policy(policy)
    g = torch.Generator().manual_seed(4)
    if paged:
        state = pol.init_paged(B, H, S, d, n_pages=B * S // 16 + 1,
                               page_size=16, device=dev)
        row = pol.init_state(1, H, S, d, device=dev, ragged=True)
        for slot in range(B):
            pol.insert_row_paged(state, row, slot, [], 0, S // 16)
    else:
        state = pol.init_state(B, H, S, d, device=dev, ragged=True)
    for lo, hi in ((0, 112), (112, 200)):
        k, v = (torch.randn((B, H, hi - lo, d), generator=g).to(dev)
                for _ in "kv")
        pol.prefill_chunk(state, k, v)
    length = state.length
    length.copy_(torch.tensor([0, 77, 200], dtype=torch.int32))
    q = torch.randn((B, Hq, 1, d), generator=g).to(dev)
    out = torch.empty((B, Hq, 1, d), device=dev)

    def step():
        out.copy_(pol.attend(q, state, backend="blockwise", kv_block=48))

    graph = StepGraph(step, [out])
    graph.replay()
    replayed = out.clone()
    step()
    assert torch.equal(replayed, out) and torch.isfinite(out).all()
    length.copy_(torch.tensor([5, 150, 64], dtype=torch.int32))
    graph.replay()
    replayed = out.clone()
    step()
    assert torch.equal(replayed, out)


# ------------------------------------------------- speculative decoding

SPEC_S_MAX = 128


@pytest.fixture(scope="module")
def smol_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    model = LM(get_config("smol-d64"), device="cuda")
    return model, model.init(model.generator(0))


def _spec_run(model, params, policy, prompt, n, drafter, graph,
              backend=None):
    """prefill, then ``decode_spec`` of n tokens with ``drafter`` as the
    drafter's history: (tokens, stats, cache)."""
    from repro_torch.launch.engine import Engine

    cache = model.init_cache(1, SPEC_S_MAX, policy=policy, ragged=True,
                             generator=torch.Generator().manual_seed(3))
    eng = Engine(model, backend=backend, graph=graph)
    lg, cache = eng.prefill(params, prompt, cache)
    tok0 = lg[:, -1].argmax(-1)[:, None]
    out, cache, stats = eng.decode_spec(params, tok0, cache, n,
                                        prompt=drafter, spec_k=4)
    return torch.cat([tok0, out], 1), stats, cache


def _valid_bytes(cache) -> list:
    """Every byte a later read can see: packed storage below each layer's
    packed length, the ring, the lengths (int4); the K/V below the length
    (bf16)."""
    out = []
    for st in cache["attn"]:
        d = st.data
        kv = getattr(d, "kv", d)
        L = int(kv.length[0])
        if hasattr(kv, "k_packed"):
            p = L - L % kv.window
            out += [kv.k_packed[:, :, :p], kv.k_scales[:, :, :p],
                    kv.v_packed[:, :, :p], kv.v_scales[:, :, :p],
                    kv.k_residual, kv.v_residual, kv.length]
        else:
            out += [kv.k[:, :, :L], kv.v[:, :, :L], kv.length]
    return out


@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_spec_graph_pass_equals_eager_across_a_flush_boundary(smol_card,
                                                              policy):
    """The prompt ends one token before the flush boundary at 32 and the
    drafter is fed the stream's own continuation, so the first pass (the
    capture's warm-up pass too) keeps all 4 tokens, past the boundary.
    The captured passes then give the eager passes' tokens, counters and
    every readable cache byte: the warm-up's ring wrap was undone."""
    model, params = smol_card
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, 31),
                           generator=g).cuda()
    first, _, _ = _spec_run(model, params, policy, prompt, 6, prompt, False)
    t = first[0].tolist()
    other = (t[0] + 1) % model.cfg.vocab_size
    drafter = torch.tensor([[other, t[0], t[1], t[2], t[3], other]]).cuda()
    runs = {graph: _spec_run(model, params, policy, prompt, 6, drafter,
                             graph) for graph in (True, False)}
    (t_g, st_g, c_g), (t_e, st_e, c_e) = runs[True], runs[False]
    assert torch.equal(t_g, t_e)
    assert st_g == st_e and st_e["accepted"] >= 3, st_e
    for a, b in zip(_valid_bytes(c_g), _valid_bytes(c_e)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["int4-srft", "bf16"])
def test_engine_spec_equals_plain_under_gather_on_card(smol_card, policy):
    """Graph spec against the plain graph decode, GATHER: tokens equal up
    to a near-tie of the plain logits (cuBLAS may round a row of the
    k-row verify products otherwise than the one-row step's)."""
    from repro_torch.launch.engine import Engine

    model, params = smol_card
    g = torch.Generator().manual_seed(5)
    base = torch.randint(0, model.cfg.vocab_size, (1, 8), generator=g)
    prompt = base.repeat(1, 5).cuda()
    cache = model.init_cache(1, SPEC_S_MAX, policy=policy, ragged=True,
                             generator=torch.Generator().manual_seed(3))
    ref, logits, _ = Engine(model).generate(params, prompt, cache, 24,
                                            return_logits=True)
    got, stats, _ = _spec_run(model, params, policy, prompt, 23, prompt,
                              True)
    diff = (ref[0] != got[0]).nonzero()
    if len(diff):
        i = int(diff[0])
        top2 = logits[0, i].topk(2).values
        assert top2[0] - top2[1] < 0.05 * logits.abs().max(), (i, top2)
    assert 0 <= stats["accepted"] <= stats["drafted"]


@pytest.mark.parametrize("paged", [False, True])
def test_spec_pass_launches_b3_per_append_and_no_b1_b2(smol_card, paged):
    """An int4 KERNEL verify pass launches B3 2 x n_layers x k times (the
    ring quantized at each append, K and V) and no B1 / B2, counted per
    replay by the captured pass (Engine) and step (BatchEngine), and
    over a decode by the counters."""
    from repro_torch.launch import graphs
    from repro_torch.launch.batch_engine import BatchEngine, Request
    from repro_torch.launch.engine import SPEC_KEY

    model, params = smol_card
    L, k = model.cfg.n_layers, 4
    per_pass = (0, 0, 2 * L * k, 0)
    g = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, 40),
                           generator=g).cuda()
    if not paged:
        before = graphs.launch_counts()
        _, stats, cache = _spec_run(model, params, "int4-srft", prompt, 12,
                                    prompt, True, backend="kernel")
        assert cache[SPEC_KEY].step.counts == per_pass
        ran = [a - b for a, b in zip(graphs.launch_counts(), before)]
        assert ran[0] == ran[1] == ran[3] == 0, ran
    eng = BatchEngine(model, params, capacity=2, s_max=SPEC_S_MAX,
                      policy="int4-srft", backend="kernel", paged=paged,
                      spec_k=k)
    before = graphs.launch_counts()
    done = list(eng.run([Request(i, prompt[0, :30 + 5 * i].cpu().numpy(),
                                 10) for i in range(3)]))
    assert len(done) == 3 and eng._step_graph.counts == per_pass
    ran = [a - b for a, b in zip(graphs.launch_counts(), before)]
    assert ran[0] == ran[1] == 0, ran


# ------------------------------------------------------ serving front-end

def test_pipeline_equals_sync_with_the_graph_captured_under_a_scrape(
        smol_card):
    """The decode thread captures the step graph (its first ``step()``)
    while another thread scrapes ``/metrics`` over HTTP without pause:
    every device touch is under the engine lock, so the capture succeeds,
    and the pipelined streams equal the sync loop's bit for bit, paged
    int4 KERNEL (B3 writes, B2 reads), with B3 and B2 launched."""
    import threading
    import time
    import urllib.request

    from repro_torch.launch import graphs
    from repro_torch.launch.batch_engine import BatchEngine
    from repro_torch.launch.server import (CompletionServer, ServingPipeline,
                                           SyncServer, make_requests)
    from repro_torch.launch.server.pipeline import drain_stream

    model, params = smol_card
    reqs = make_requests(6, prompt_len=64, new_tokens=12, align=16,
                         run_len=2)

    def engine():
        return BatchEngine(model, params, capacity=3, s_max=96,
                           policy="int4-srft", backend="kernel", chunk=4,
                           paged=True, page_size=16)

    eng = engine()
    srv = SyncServer(eng, max_group=3)
    streams = {r.rid: srv.submit(r) for r in reqs}
    srv.run_until_drained()
    want = {rid: drain_stream(q, 60) for rid, q in streams.items()}
    srv.close()

    eng = engine()
    pipe = ServingPipeline(eng, max_group=3, admit_queue=8)
    server = CompletionServer(pipe, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    stop, scrapes = threading.Event(), []

    def scrape():
        while not stop.is_set():
            with urllib.request.urlopen(server.url + "/metrics",
                                        timeout=30) as resp:
                scrapes.append(resp.status)

    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    while not scrapes:
        time.sleep(0.001)
    before = graphs.launch_counts()
    streams = {r.rid: pipe.submit(r) for r in reqs}
    pipe.start()
    try:
        got = {rid: drain_stream(q, 120) for rid, q in streams.items()}
    finally:
        stop.set()
        scraper.join(30)
        server.shutdown()
        assert pipe.shutdown(timeout=60.0)
    ran = [a - b for a, b in zip(graphs.launch_counts(), before)]
    assert got == want
    assert eng._step_graph is not None and len(scrapes) > 1
    assert set(scrapes) == {200}
    assert ran[1] > 0 and ran[2] > 0 and ran[0] == 0, ran
    assert eng.pool_stats()["pages_used"] == 0


@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_sharded_batch_graph_equals_eager_and_unsharded(dev, backend):
    """On one card a (1, 2) mesh of the same device captures the decode
    step: graph == eager == unsharded, streams and every cache leaf (the
    capture's warm-up puts back every shard's lengths).  Under KERNEL each
    shard reads through B2, which the eager sharded run launches twice as
    often as the eager unsharded one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_attention import ops as qa
    from repro_torch.launch import partitioning as pt
    from repro_torch.launch import sharded_cache as sc
    from repro_torch.launch.batch_engine import BatchEngine, Request
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM

    model = LM(get_config("smol-d64"), device=dev)
    params = model.init(_gen(dev, 0))
    mesh = make_mesh((1, 2), ("data", "model"), devices=[dev] * 2)
    g = torch.Generator().manual_seed(3)
    reqs = [Request(rid=i, prompt=torch.randint(0, 256, (n,), generator=g)
                    .numpy(), max_new_tokens=m)
            for i, (n, m) in enumerate(((9, 10), (17, 8), (23, 6)))]
    kw = dict(policy="int4-srft", backend=backend, paged=True,
              page_size=16, capacity=3, s_max=64, chunk=4)
    out, b2 = {}, {}
    for name, m, graph in (("ref", None, False), ("eager", mesh, False),
                           ("graph", mesh, True)):
        qa.paged_launches = 0
        eng = BatchEngine(model, params, mesh=m, graph=graph, **kw)
        out[name] = ({c.rid: tuple(c.tokens.tolist())
                      for c in eng.run(list(reqs))}, eng)
        b2[name] = qa.paged_launches
    if backend == "kernel":
        assert b2["ref"] > 0 and b2["eager"] == 2 * b2["ref"], b2
    assert out["graph"][0] == out["eager"][0] == out["ref"][0]
    for name in ("eager", "graph"):
        for a, b in zip(out["ref"][1].cache["attn"],
                        out[name][1].cache["attn"]):
            la = pt.flatten_with_path(a)
            lb = pt.flatten_with_path(sc.gather_state(b))
            for (pth, x), (_, y) in zip(la, lb):
                assert torch.equal(x, y), (name, pth)


LSE_ATOL = 1e-4  # the log of sums that differ by ~1e-6 relative


@pytest.mark.parametrize("S,plen,tlen", [(4608, 4144, 4156),
                                         (1536, 1536, 1547),
                                         (288, 0, 0)])
@pytest.mark.parametrize("per_row", [False, True])
def test_b1_lse_matches_plain_and_leaves_the_output_alone(dev, S, plen,
                                                          tlen, per_row):
    """B1's optional log-sum-exp against its plain version's: at the main
    path's read (4,144 packed + 12), at a split-K shard of S_MAX 4608 on
    m = 3 (a full 1536-position segment and the ring) and at an empty
    segment, whose lse is the -1e30 sentinel and whose output is finite.
    The output with the pointer equals the output without it bit for
    bit."""
    BH = 8
    args = _b1_args(dev, S + plen, BH, 2, 128, S, 16, 32)
    if per_row:
        plen = torch.full((BH,), plen, dtype=torch.int32, device=dev)
        tlen = torch.full((BH,), tlen, dtype=torch.int32, device=dev)
        plen[BH // 2:] = tlen[BH // 2:] = 0  # half the rows empty
    out, lse = qa_ops.quant_decode_attention(*args, plen, tlen, group=32,
                                             return_lse=True)
    plain = qa_ops.quant_decode_attention(*args, plen, tlen, group=32)
    want_o, want = qa_ref.quant_decode_attention_ref(
        *args, plen, tlen, group=32, return_lse=True)
    assert torch.equal(out, plain)
    assert torch.isfinite(out).all() and lse.shape == (BH, 2)
    torch.testing.assert_close(out, want_o, atol=B1_ATOL, rtol=0)
    torch.testing.assert_close(lse, want, atol=LSE_ATOL, rtol=0)
    empty = (tlen == 0) if per_row else torch.full((BH,), tlen == 0,
                                                   device=dev)
    assert (lse[empty] == -1e30).all()


@pytest.mark.parametrize("policy,backend", [("int4-srft", "kernel"),
                                            ("bf16", "gather")])
def test_split_k_engine_graph_equals_eager_on_card(dev, policy, backend):
    """A (1, 3) mesh of the card over smol-d64 (2 KV heads): split-K.  The
    captured step equals the eager loop (tokens and every gathered cache
    leaf); against the unsharded eager run, tokens up to a near-tie; the
    eager split run launches B1 once per shard, 3 times as often."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_attention import ops as qa
    from repro_torch.launch import partitioning as pt
    from repro_torch.launch import sharded_cache as sc
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM

    model = LM(get_config("smol-d64"), device=dev)
    params = model.init(_gen(dev, 0))
    mesh = make_mesh((1, 3), ("data", "model"), devices=[dev] * 3)
    prompt = torch.randint(0, 256, (1, 37), generator=_gen(dev, 5),
                           device=dev)
    out, launches = {}, {}
    for name, m, graph in (("ref", None, False), ("eager", mesh, False),
                           ("graph", mesh, True)):
        eng = Engine(model, backend=backend, graph=graph, mesh=m)
        cache = eng.shard_cache(model.init_cache(1, 72, policy=policy,
                                                 ragged=True),
                                allow_split_k=True)
        qa.launches = 0
        toks, logits, cache = eng.generate(params, prompt, cache, 24,
                                           return_logits=True)
        out[name] = (toks, logits, cache)
        launches[name] = qa.launches
    assert torch.equal(out["graph"][0], out["eager"][0])
    for a, b in zip(out["eager"][2]["attn"], out["graph"][2]["attn"]):
        for (pth, x), (_, y) in zip(pt.flatten_with_path(sc.gather_state(a)),
                                    pt.flatten_with_path(sc.gather_state(b))):
            assert torch.equal(x, y), pth
    ref_t, ref_l = out["ref"][0], out["ref"][1]
    diff = torch.nonzero(out["graph"][0] != ref_t)
    if len(diff):
        i = int(diff[:, 1].min())
        top2 = ref_l[0, i].topk(2).values
        assert top2[0] - top2[1] < 0.05 * ref_l.abs().max(), i
    if backend == "kernel":
        assert launches["ref"] > 0
        assert launches["eager"] == 3 * launches["ref"], launches


@pytest.mark.parametrize("policy,backend", [("int4-srft", "kernel"),
                                            ("bf16", "gather"),
                                            ("int8-per-token", "gather")])
def test_split_k_spec_graph_equals_eager_and_plain_on_card(dev, policy,
                                                           backend):
    """Speculative decoding on a (1, 3) split-K mesh of the card over
    smol-d64 (2 KV heads), a repetitive 37-token prompt, k = 4: the
    captured pass gives the eager passes' tokens, counters and every
    readable cache byte; against the split-K plain graph stream, tokens
    up to a near-tie (cuBLAS may round a row of the k-row verify products
    otherwise than the one-row step's); a pass launches B3 2 x n_layers x
    k times on an int4 cache and no B1; layer 0's verify read equals the
    split decode read bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_attention import ops as qa
    from repro_torch.launch import partitioning as pt
    from repro_torch.launch import sharded_cache as sc
    from repro_torch.launch.engine import SPEC_KEY, Engine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM

    model = LM(get_config("smol-d64"), device=dev)
    params = model.init(_gen(dev, 0))
    mesh = make_mesh((1, 3), ("data", "model"), devices=[dev] * 3)
    base = torch.randint(0, 256, (1, 8), generator=_gen(dev, 5), device=dev)
    prompt = base.repeat(1, 5)[:, :37]
    L, k, n = model.cfg.n_layers, 4, 24

    def split_cache(eng):
        return eng.shard_cache(model.init_cache(1, 72, policy=policy,
                                                ragged=True),
                               allow_split_k=True)

    eng = Engine(model, backend=backend, mesh=mesh)
    ref, logits, plain = eng.generate(params, prompt, split_cache(eng), n,
                                      return_logits=True)
    out = {}
    for graph in (True, False):
        eng = Engine(model, backend=backend, graph=graph, mesh=mesh)
        before = (qa.launches, sq_ops.launches)
        toks, cache, stats = eng.generate_spec(params, prompt,
                                               split_cache(eng), n, spec_k=k)
        out[graph] = (toks, cache, stats,
                      (qa.launches - before[0], sq_ops.launches - before[1]))
    (t_g, c_g, st_g, n_g), (t_e, c_e, st_e, n_e) = out[True], out[False]
    assert torch.equal(t_g, t_e) and st_g == st_e, (st_g, st_e)

    def readable(state):
        """A gathered state's bytes a read can see."""
        d = sc.gather_state(state).data
        L = int(d.length.max())
        if hasattr(d, "kv"):
            p = L - L % d.kv.window
            return [t[:, :, :p] for t in sc._seq_leaves(d)] + [
                d.kv.k_residual, d.kv.v_residual, d.length]
        return [t[:, :, :L] for t in sc._seq_leaves(d)] + [d.length]

    for a, b in zip(c_g["attn"], c_e["attn"]):
        for x, y in zip(readable(a), readable(b), strict=True):
            assert torch.equal(x, y)
    assert c_g[SPEC_KEY].step.counts == (
        0, 0, 2 * L * k if policy == "int4-srft" else 0, 0)
    assert n_g[0] == n_e[0] == 0, (n_g, n_e)  # no B1 in any verify pass
    if policy == "int4-srft":
        assert n_e[1] == st_e["passes"] * 2 * L * k + 2 * L, n_e
    diff = (ref[0] != t_g[0]).nonzero()
    if len(diff):
        i = int(diff[0])
        top2 = logits[0, i].topk(2).values
        assert top2[0] - top2[1] < 0.05 * logits.abs().max(), (i, top2)
    # layer 0's verify read against the split decode read
    st = plain["attn"][0]
    pol = st.policy
    clone = lambda s: pt.tree_map_with_path(  # noqa: E731
        lambda _, t: t.clone() if isinstance(t, torch.Tensor) else t, s)
    ver, seq = st.map_shards(clone), st.map_shards(clone)
    Hkv, d = model.cfg.n_kv_heads, model.cfg.head_dim
    g = _gen(dev, 9)
    kv = [tuple(torch.randn((1, Hkv, 1, d), generator=g, device=dev)
                .to(torch.bfloat16) for _ in "kv") for _ in range(k)]
    q = torch.randn((1, model.cfg.n_heads, k, d), generator=g, device=dev)
    snap = pol.snapshot_rows(ver)
    for kk, vv in kv:
        pol.update(ver, kk, vv)
    got = pol.verify_attend(q, ver, snap, backend=backend)
    for i, (kk, vv) in enumerate(kv):
        pol.update(seq, kk, vv)
        assert torch.equal(got[:, :, i:i + 1], pol.attend(
            q[:, :, i:i + 1], seq, backend="gather")), i


@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_tracing_adds_no_sync_and_reads_the_device_clock(smol_card,
                                                         prefill_chunk):
    """Paged int4 KERNEL ``BatchEngine`` on its decode graph, monolithic
    and chunked admission, the same requests traced and untraced: the
    streams are equal, the synchronising calls counted under
    ``set_sync_debug_mode("warn")`` are as many (the device spans resolve
    after the engine's own readbacks), every device span has a positive
    ``dev_ms`` (a decode chunk's inside its host span, ``gap_ms`` after
    the first), each request's ``prefill_s`` is the device time of its
    prefills, and the event pool did not grow."""
    import warnings

    from repro_torch.launch.batch_engine import BatchEngine
    from repro_torch.launch.server import TraceRecorder, make_requests

    model, params = smol_card
    reqs = make_requests(5, prompt_len=64, new_tokens=12, align=16,
                         run_len=2)

    def run(rec):
        eng = BatchEngine(model, params, capacity=3, s_max=96,
                          policy="int4-srft", backend="kernel", chunk=4,
                          paged=True, page_size=16,
                          prefill_chunk=prefill_chunk, trace=rec)
        streams = {r.rid: [] for r in reqs}
        eng.submit(reqs[0])
        while eng._step_graph is None:  # the capture, outside the count
            for rid, toks in eng.step()[0]:
                streams[rid] += toks
        for r in reqs[1:]:
            eng.submit(r)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                while eng.has_work:
                    for rid, toks in eng.step()[0]:
                        streams[rid] += toks
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        return streams, syncs, eng

    run(TraceRecorder(enabled=False))  # first uses of shapes sync once
    rec = TraceRecorder()
    on, syncs_on, eng = run(rec)
    off, syncs_off, _ = run(TraceRecorder(enabled=False))
    assert on == off
    assert syncs_on == syncs_off > 0
    spans = [e for e in rec.export()["traceEvents"] if e["ph"] == "X"]
    chunks = [e for e in spans if e["name"] == "decode.chunk"]
    dev = [e for e in spans if e["name"] == "decode.device"]
    assert len(dev) == len(chunks) > 2
    for d, c in zip(dev, chunks):
        assert 0 < d["args"]["dev_ms"] < c["dur"] / 1e3
    assert all(d["args"]["gap_ms"] > 0 for d in dev[1:])
    hosts = [e for e in spans if e["name"] in ("engine.prefill",
                                               "prefill.chunk")]
    pre = [e for e in spans if e["name"] == "prefill.device"]
    assert len(pre) == len(hosts) >= len(reqs)
    charged = {r.rid: 0.0 for r in reqs}
    for p in pre:
        assert p["args"]["dev_ms"] > 0
        charged[p["args"]["rid"]] += p["args"]["dev_ms"] / 1e3
    for r in reqs:
        assert rec.req_timing(r.rid)["prefill_s"] == pytest.approx(
            charged[r.rid], abs=2e-6)
    assert eng._clock.pending == 0 and len(eng._clock._free) == 15
