"""The CUDA kernels against their plain versions, on the card.  The kernels
have no CPU mode, so these tests skip without a CUDA device; they import
neither JAX nor the reference, so they run where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import make_accum_sketch  # noqa: E402
from repro_torch.core.kernels_math import get_kernel  # noqa: E402
from repro_torch.kernels.accum_apply import autotune as AT  # noqa: E402
from repro_torch.kernels.accum_apply import kernel as KT  # noqa: E402
from repro_torch.kernels.accum_apply import ops as OT  # noqa: E402
from repro_torch.kernels.accum_apply import ref as RT  # noqa: E402
from repro_torch.kernels.landmark_attention import kernel as LK  # noqa: E402
from repro_torch.kernels.landmark_attention import ops as LO  # noqa: E402
from repro_torch.kernels.landmark_attention import ref as LR  # noqa: E402

KERNELS = [("gaussian", 0.6, 1.5), ("laplacian", 1.0, 1.5), ("matern", 0.8, 0.5),
           ("matern", 0.8, 1.5), ("matern", 0.8, 2.5)]
CUSP = {("laplacian", 1.5), ("matern", 0.5)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(out, plain, tol):
    """allclose with atol = tol·max|plain| (outputs scale with the
    coefficients r/sqrt(d·m·p))."""
    out, plain = out.double(), plain.double()
    scale = plain.abs().max().item()
    torch.testing.assert_close(out, plain, rtol=tol, atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,p,d,m", [(1000, 3, 24, 4), (173, 9, 9, 3), (300, 40, 70, 2)])
def test_cuda_kernels_match_plain(cuda_device, n, p, d, m, dtype):
    g = torch.Generator().manual_seed(n + p)
    X = torch.randn((n, p), generator=g).to(cuda_device, dtype)
    sk = make_accum_sketch(g, n, d, m, device=cuda_device)
    idx, cf = sk.indices, sk.coef
    L = X.index_select(0, idx.reshape(-1))
    for kernel, bw, nu in KERNELS:
        out = KT.matfree_apply(X, L, cf, kernel=kernel, bandwidth=bw, nu=nu)
        if (kernel, nu if kernel == "matern" else 1.5) in CUSP:
            # the self-pair cusp of the expanded distance: against float64
            plain = RT.landmark_cols_ref(X.double(), L.double(), cf.double(),
                                         get_kernel(kernel, bw, nu))
            _close(out, plain, 5e-3)
        else:
            plain = RT.landmark_cols_ref(X.float(), L.float(), cf,
                                         get_kernel(kernel, bw, nu))
            _close(out, plain, 1e-5 if dtype == torch.float32 else 5e-2)
    M = out.to(dtype)
    _close(KT.accum_apply_left(M, idx, cf), RT.sketch_left_ref(idx, cf, M),
           1e-5 if dtype == torch.float32 else 3e-2)
    K = torch.randn((n, n), generator=g).to(cuda_device, dtype)
    C, W = KT.accum_sketch_both(K, idx, cf)
    Cr, Wr = RT.sketch_both_ref(K, idx, cf)
    assert C.dtype == dtype and W.dtype == torch.float32
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    _close(C, Cr, tol)
    _close(W, Wr, tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 3, 4, 7])
def test_cuda_matfree_at_m16_every_record_layout(cuda_device, p, dtype):
    """matfree_apply at the engine's m = 16, d = 64, for one float4 record a
    landmark (p ≤ 3) and two (p ≤ 7), on n = 1237 rows (a multiple of no
    candidate's rows a block): every kernel kind against its plain version,
    and every rows-a-block candidate the static geometry's bits."""
    g = torch.Generator().manual_seed(p)
    n, d, m = 1237, 64, 16
    X = torch.rand((n, p), generator=g).to(cuda_device, dtype)
    sk = make_accum_sketch(g, n, d, m, device=cuda_device)
    L = X.index_select(0, sk.indices.reshape(-1))
    for kernel, bw, nu in KERNELS:
        out = KT.matfree_apply(X, L, sk.coef, kernel=kernel, bandwidth=bw, nu=nu)
        if (kernel, nu if kernel == "matern" else 1.5) in CUSP:
            plain = RT.landmark_cols_ref(X.double(), L.double(), sk.coef.double(),
                                         get_kernel(kernel, bw, nu))
            _close(out, plain, 5e-3)
        else:
            plain = RT.landmark_cols_ref(X.float(), L.float(), sk.coef,
                                         get_kernel(kernel, bw, nu))
            _close(out, plain, 1e-5 if dtype == torch.float32 else 5e-2)
    _candidates_equal_static(
        lambda c: (KT.matfree_apply(X, L, sk.coef, kernel="gaussian", bandwidth=0.5,
                                    bm=c[0]),),
        OT._rows_candidates(OT.MATFREE_ROWS, n, (64,)) + [(1,), (100,)], (64,))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 16, 17])
def test_cuda_gather_edges(cuda_device, B, dtype):
    """The column gather on a ragged R = N = 3001 at d = 64: B = 1 and 16
    take the sorted kernel, B = 17 (m·d above 1024) the row-at-a-time one.
    An index ≥ N and a negative one make NaN in their columns and nowhere
    else; the rest holds the plain version; accum_grow_slabs written over
    its own Cin gives the bits of a separate output; every rows-a-block
    candidate gives the static geometry's bits."""
    g = torch.Generator().manual_seed(B)
    R = N = 3001
    d = 64
    K = torch.randn((R, N), generator=g).to(cuda_device, dtype)
    idx = torch.randint(0, N, (B, d), generator=g, dtype=torch.int32)
    coef = torch.randn((B, d), generator=g)
    Cin = torch.randn((R, d), generator=g).to(cuda_device)
    bad = {3: N, 40: -7}
    good = idx.clone()
    for j, v in bad.items():
        idx[B - 1, j] = v
    idx, good, coef = idx.to(cuda_device), good.to(cuda_device), coef.to(cuda_device)
    cols = [j for j in range(d) if j not in bad]
    f32 = dtype == torch.float32
    out = KT.accum_apply(K, idx, coef)
    assert bool(out[:, list(bad)].float().isnan().all())
    assert not bool(out[:, cols].float().isnan().any())
    _close(out[:, cols], RT.accum_apply_ref(K, good, coef)[:, cols], 1e-5 if f32 else 2e-2)
    C_new, TtG, TtC = KT.accum_grow_slabs(K, good, coef, Cin, 0.6)
    for x, y in zip((C_new, TtG, TtC), RT.accum_grow_ref(K, good, coef, Cin, 0.6)):
        _close(x, y, 1e-4)
    C2 = Cin.clone()
    again = KT.accum_grow_slabs(K, good, coef, C2, 0.6, out=C2)
    assert again[0].data_ptr() == C2.data_ptr()
    assert all(torch.equal(x, y) for x, y in zip(again, (C_new, TtG, TtC)))
    _candidates_equal_static(lambda c: KT.accum_grow_slabs(K, good, coef, Cin, 0.6, bm=c[0]),
                             OT._gemm_candidates(R, (64,)) + [(1,), (100,)], (64,))
    _candidates_equal_static(lambda c: (KT.accum_apply(K, good, coef, bm=c[0]),),
                             OT._gemm_candidates(R, (64,)) + [(1,)], (64,))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wrappers_route_cuda_tensors_to_the_kernels(cuda_device):
    g = torch.Generator().manual_seed(0)
    X = torch.rand((500, 3), generator=g).to(cuda_device)
    sk = make_accum_sketch(g, 500, 16, 3, device=cuda_device)
    KT.reset_launches()
    C = OT.matfree_cols_kernel(X, X.index_select(0, sk.indices.reshape(-1)),
                               sk.coef, kernel="gaussian", bandwidth=0.5)
    OT.sketch_left_kernel(sk, C)
    K = get_kernel("gaussian", 0.5)(X, X)
    OT.sketch_both_kernel(K, sk)
    OT.sketch_right_kernel(K, sk)
    OT.sketch_step_kernel(K, sk.indices[0], sk.coef[0], C, 0.5)
    OT.accum_grow_kernel(K, sk.indices, sk.coef, C, 0.5)
    OT.accum_apply_scalar(K, sk.indices, sk.coef, bm=100, bd=8)
    assert [f.launches for f in KT.KERNELS] == [1] * 7
    # the same calls on bad input raise instead of falling back
    with pytest.raises(TypeError):
        OT.sketch_left_kernel(sk, C.double())
    assert KT.accum_apply_left.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N,d,B", [(173, 173, 9, 3), (256, 256, 16, 4),
                                     (128, 128, 64, 1), (64, 8969, 16, 2),
                                     (1000, 1000, 24, 16)])
def test_cuda_progressive_kernels_match_plain(cuda_device, R, N, d, B, dtype):
    """accum_apply, accum_step_slab and accum_grow_slabs against their plain
    versions: odd shapes, a wide K, bfloat16 K, and the grow kernel written
    over its own Cin (TᵀC must come from the old Cin)."""
    g = torch.Generator().manual_seed(R + N + d + B)
    K = torch.randn((R, N), generator=g).to(cuda_device, dtype)
    idx = torch.randint(0, min(R, N), (B, d), generator=g,
                        dtype=torch.int32).to(cuda_device)
    coef = torch.randn((B, d), generator=g).to(cuda_device)
    Cin = torch.randn((R, d), generator=g).to(cuda_device)
    a = 0.77
    f32 = dtype == torch.float32
    out = KT.accum_apply(K, idx, coef)
    assert out.dtype == dtype
    _close(out, RT.accum_apply_ref(K, idx, coef), 1e-5 if f32 else 2e-2)
    step = KT.accum_step_slab(K, idx[:1].contiguous(), coef[:1].contiguous(), Cin, a)
    _close(step, RT.accum_step_ref(K, idx[:1], coef[:1], Cin, a), 1e-5)
    plain = RT.accum_grow_ref(K, idx, coef, Cin, a)
    for x, y in zip(KT.accum_grow_slabs(K, idx, coef, Cin, a), plain):
        _close(x, y, 1e-4)
    C2 = Cin.clone()
    Cn, TtG, TtC = KT.accum_grow_slabs(K, idx, coef, C2, a, out=C2)
    assert Cn.data_ptr() == C2.data_ptr()
    for x, y in zip((Cn, TtG, TtC), plain):
        _close(x, y, 1e-4)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_engine_routes_match_plain(cuda_device):
    """The engine on a dense K on the card (unit steps through
    accum_step_slab, batches through accum_grow_slabs) against its plain
    route on the same draw, to the reference's 1e-5."""
    from repro_torch.core import apply as A

    g = torch.Generator().manual_seed(5)
    X = torch.rand((600, 3), generator=g).to(cuda_device)
    K = get_kernel("gaussian", 0.6)(X, X)
    st = A.accum_init(torch.Generator().manual_seed(0), 600, 16, 8,
                      device=cuda_device)
    for grow in (lambda s, uk: A.accum_grow(K, s, 5, use_kernel=uk),
                 lambda s, uk: A.accum_grow_batched(K, s, 6, use_kernel=uk)):
        got, plain = grow(st, True), grow(st, False)
        for x, y in ((got.C, plain.C), (got.W, plain.W)):
            assert ((x - y).norm() / y.norm()).item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N,d,m,bm,bd", [(4096, 8192, 64, 4, 256, 8),
                                           (256, 512, 32, 4, 32, 8),
                                           (64, 128, 16, 3, 256, 16),
                                           (1000, 999, 24, 2, 8, 24)])
def test_cuda_scalar_kernel_matches_plain(cuda_device, R, N, d, m, bm, bd, dtype):
    """accum_apply_scalar against its plain version (the reference's tol:
    1e-5 float32, 2e-2 bfloat16), and against accum_apply."""
    g = torch.Generator().manual_seed(R + d)
    K = torch.randn((R, N), generator=g).to(cuda_device, dtype)
    idx = torch.randint(0, N, (m, d), generator=g, dtype=torch.int32).to(cuda_device)
    coef = torch.randn((m, d), generator=g).to(cuda_device)
    before = KT.accum_apply_scalar.launches
    out = KT.accum_apply_scalar(K, idx, coef, bm=bm, bd=bd)
    assert out.dtype == dtype and KT.accum_apply_scalar.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    _close(out, RT.accum_apply_ref(K, idx, coef), tol)
    _close(out, KT.accum_apply(K, idx, coef), tol)
    with pytest.raises(ValueError, match="R % bm"):
        KT.accum_apply_scalar(K[:R - 1], idx, coef, bm=min(bm, R - 2), bd=bd)
    torch.cuda.synchronize()


def _candidates_equal_static(run, cands, static):
    """Every candidate geometry's outputs equal the static geometry's bit for
    bit: the geometry picks a block, never a sum's order."""
    want = run(static)
    for c in cands:
        for x, y in zip(run(c), want):
            assert torch.equal(x, y), f"geometry {c} differs from {static}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_autotune_candidates_match_static_accum(cuda_device, dtype):
    g = torch.Generator().manual_seed(11)
    n, d, m, B = 1000, 24, 4, 5
    X = torch.rand((n, 3), generator=g).to(cuda_device, dtype)
    sk = make_accum_sketch(g, n, d, m, device=cuda_device)
    idx, cf = sk.indices, sk.coef
    L = X.index_select(0, idx.reshape(-1))
    K = get_kernel("gaussian", 0.5)(X.float(), X.float()).to(dtype)
    Cin = torch.randn((n, d), generator=g).to(cuda_device)
    gather = OT._gemm_candidates(n, (64,))
    assert len(gather) == 3
    _candidates_equal_static(
        lambda c: (KT.matfree_apply(X, L, cf, kernel="gaussian", bandwidth=0.5, bm=c[0]),),
        OT._rows_candidates(OT.MATFREE_ROWS, n, (64,)), (64,))
    _candidates_equal_static(lambda c: KT.accum_sketch_both(K, idx, cf, bm=c[0]),
                             gather, (64,))
    _candidates_equal_static(lambda c: (KT.accum_apply(K, idx, cf, bm=c[0]),), gather, (64,))
    _candidates_equal_static(
        lambda c: (KT.accum_step_slab(K, idx[:1].contiguous(), cf[:1].contiguous(), Cin,
                                      0.7, bm=c[0]),), gather, (64,))
    _candidates_equal_static(
        lambda c: KT.accum_grow_slabs(K, idx[:B].contiguous(), cf[:B].contiguous(), Cin,
                                      0.7, bm=c[0]), gather, (64,))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,S,L,Dh,Dv", [(4, 300, 77, 64, 130), (32, 4, 1024, 128, 128),
                                         (2, 1030, 256, 128, 128), (3, 3, 517, 256, 200),
                                         (2, 8, 100, 64, 200), (5, 1, 1000, 128, 128)])
def test_cuda_autotune_candidates_match_static_landmark(cuda_device, P, S, L, Dh, Dv,
                                                        dtype):
    """Every rows-a-block candidate the device can launch gives the static
    geometry's bits (the static geometry where it fits, ``static_rows``: a
    float32 head dim of 256 takes 64 rows): landmark_attention over its
    query rows, landmark_stats' BmV sweep over its landmark rows (W has one
    geometry)."""
    g = torch.Generator().manual_seed(P + S)
    q, kt = _randn(g, (P, S, Dh), cuda_device, dtype), _randn(g, (P, L, Dh), cuda_device, dtype)
    M = _randn(g, (P, L, Dv), cuda_device, dtype)
    bias = torch.log(torch.rand((P, L), generator=g) + 0.1).to(cuda_device)
    fb = (LK.static_rows(S, Dh, dtype, dtype, cuda_device),)
    cands = LO._bq_candidates(S, fb, Dh, dtype, dtype, cuda_device)
    assert cands[0] == fb and all(LK.fits(c[0], Dh, dtype, dtype, cuda_device)
                                  for c in cands)
    _candidates_equal_static(lambda c: (LK.landmark_attention(q, kt, M, bias, bq=c[0]),),
                             cands, fb)
    k, v = _randn(g, (P, S, Dh), cuda_device, dtype), _randn(g, (P, S, Dv), cuda_device, dtype)
    fb = (LK.static_rows(L, Dh, dtype, torch.float32, cuda_device, "landmark_stats"),)
    cands = LO._bq_candidates(L, fb, Dh, dtype, torch.float32, cuda_device)
    _candidates_equal_static(lambda c: LK.landmark_stats(kt, kt, k, v, bs=c[0]), cands, fb)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_measuring_counts_apart_and_writes_only_the_winner(cuda_device, tmp_path,
                                                                monkeypatch):
    """A cold cache on the card: the first call measures (its launches are
    counted in MEASURE_LAUNCHES, not the kernel's), persists the winner, and
    writes the caller's ``out`` once — with the static geometry's bits; the
    second call is a cache hit that times nothing."""
    from repro_torch.core import apply as A

    monkeypatch.setenv(AT.ENV_CACHE, str(tmp_path / "at.json"))
    monkeypatch.setenv(AT.ENV_GATE, "1")
    g = torch.Generator().manual_seed(3)
    n, d, B = 2048, 32, 4
    K = torch.randn((n, n), generator=g).to(cuda_device)
    st = A.accum_init(torch.Generator().manual_seed(0), n, d, 8, device=cuda_device)
    idx_blk, coef_blk, a = A.batch_pieces(st, B)
    want = KT.accum_grow_slabs(K, idx_blk.to(torch.int32).contiguous(), coef_blk.float(),
                               st.C, a)
    KT.reset_launches()
    measured = sum(AT.MEASURE_LAUNCHES.values())
    C = st.C.clone()
    got = OT.accum_grow_kernel(K, idx_blk, coef_blk, C, a, out=C)
    assert got[0].data_ptr() == C.data_ptr()
    assert KT.accum_grow_slabs.launches == 1
    assert sum(AT.MEASURE_LAUNCHES.values()) > measured
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    key = (n, n, d, B)
    assert AT.lookup("accum_grow", key, torch.float32, cuda_device, arity=1,
                     source=KT.source_hash()) is not None

    def no_timing(*a):
        raise AssertionError("a cache hit timed a candidate")

    monkeypatch.setattr(AT, "_time", no_timing)
    C2 = st.C.clone()
    OT.accum_grow_kernel(K, idx_blk, coef_blk, C2, a, out=C2)
    assert torch.equal(C2, want[0]) and KT.accum_grow_slabs.launches == 2


# --------------------------------------------------------------------------- #
# the landmark-attention kernels
# --------------------------------------------------------------------------- #

def _randn(g, shape, dev, dtype=torch.float32):
    return torch.randn(shape, generator=g).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,S,L,Dh,Dv", [(6, 4, 100, 32, 32), (3, 130, 77, 16, 24),
                                         (2, 70, 40, 64, 200), (4, 1, 1024, 128, 128),
                                         (2, 300, 33, 80, 80), (32, 4, 1024, 128, 128),
                                         (5, 3, 1000, 64, 200), (3, 8, 517, 256, 200),
                                         (7, 1, 333, 128, 64), (2, 4, 4097, 256, 128),
                                         (2, 2, 7, 64, 5)])
def test_cuda_landmark_attention_matches_plain(cuda_device, P, S, L, Dh, Dv, dtype):
    """Odd S and L (the kernel masks its ragged edges), Dv above one value
    tile, the decode shape with a bias lane mixing log-mass with −1e30, and
    a row whose every landmark is masked (uniform weights, no NaN).  The
    decode sweep (S ≤ 8) at 1, 2, 3, 4 and 8 rows, over slot counts that
    are no multiple of a warp's, a block's or a split's run, at head dims
    64 to 256, value widths of two chunks (200) and of no multiple of 4 (5,
    element loads), and with no bias.  float32 at 1e-5 of max|plain| (sum
    order only); bfloat16 output at 2e-2 (one rounding of the output).  Two
    calls give the same bits."""
    g = torch.Generator().manual_seed(P + S + L)
    q, kt = _randn(g, (P, S, Dh), cuda_device, dtype), _randn(g, (P, L, Dh), cuda_device, dtype)
    M = _randn(g, (P, L, Dv), cuda_device, dtype)
    bias = torch.log(torch.rand((P, L), generator=g) * 3 + 0.1)
    bias[:, ::3] = -1e30
    bias[0] = -1e30
    bias = bias.to(cuda_device)
    out = LK.landmark_attention(q, kt, M, bias)
    plain = LR.landmark_attention_ref(q, kt, M, bias)
    assert out.dtype == dtype and out.isfinite().all()
    _close(out, plain, 1e-5 if dtype == torch.float32 else 2e-2)
    _close(LK.landmark_attention(q, kt, M), LR.landmark_attention_ref(q, kt, M),
           1e-5 if dtype == torch.float32 else 2e-2)
    assert torch.equal(LK.landmark_attention(q, kt, M, bias), out)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_landmark_decode_at_head_dim_112(cuda_device, dtype):
    """zamba2-7b's shared attention (32 heads of 112, no GQA) is the first
    serving path whose decode sweep runs at a head dim other than 128: its
    loads of 4 elements stop at 112, inside the 128-wide chunk.  B·Hkv =
    4·32 problems of G = 1 row over d_slots = 1024 slots with a decode's
    bias lane, through the kernel and through ``landmark_attend`` (the
    sketched decode's entry point); float32 at 1e-5, bfloat16 at 2e-2."""
    g = torch.Generator().manual_seed(112)
    P, S, L, Dh = 128, 1, 1024, 112
    q, kt = _randn(g, (P, S, Dh), cuda_device, dtype), _randn(g, (P, L, Dh), cuda_device, dtype)
    M = _randn(g, (P, L, Dh), cuda_device, dtype)
    mass = torch.rand((P, L), generator=g) * 3
    bias = torch.where(mass < 0.3, -1e30, torch.log(mass)).to(cuda_device)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    before = LK.landmark_attention.launches
    out = LK.landmark_attention(q, kt, M, bias)
    plain = LR.landmark_attention_ref(q, kt, M, bias)
    assert out.dtype == dtype and out.isfinite().all()
    _close(out, plain, tol)
    _close(LO.landmark_attend(q, kt, M, bias), plain, tol)
    assert LK.landmark_attention.launches == before + 2
    assert torch.equal(LK.landmark_attention(q, kt, M, bias), out)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,L,S,Dh,Dv,nv,lv", [(3, 50, 300, 16, 24, 270, 45),
                                               (2, 130, 2049, 64, 64, 2049, 130),
                                               (1, 7, 5, 8, 5, 3, 2),
                                               (3, 4, 2049, 128, 200, 2000, 4),
                                               (2, 8, 700, 256, 128, 650, 8),
                                               (4, 1, 100, 64, 64, 99, 1)])
def test_cuda_landmark_stats_matches_plain(cuda_device, P, L, S, Dh, Dv, nv, lv, dtype):
    """W and BmV with keys ≥ n_valid and landmark columns ≥ l_valid masked,
    against the plain version with the same masks: float32 sums, held at
    1e-5 of max|plain| (bfloat16 inputs are widened exactly, so the same).
    L ≤ 8 takes the decode sweep for BmV, with its n_valid mask."""
    g = torch.Generator().manual_seed(P + L + S)
    qt, kt = _randn(g, (P, L, Dh), cuda_device, dtype), _randn(g, (P, L, Dh), cuda_device, dtype)
    k, v = _randn(g, (P, S, Dh), cuda_device, dtype), _randn(g, (P, S, Dv), cuda_device, dtype)
    W, BmV = LK.landmark_stats(qt, kt, k, v, n_valid=nv, l_valid=lv)
    Wr, BmVr = LR.landmark_stats_ref(qt, kt, k, v, n_valid=nv, l_valid=lv)
    assert W.dtype == BmV.dtype == torch.float32
    _close(W, Wr, 1e-5)
    _close(BmV, BmVr, 1e-5)
    assert torch.equal(LK.landmark_stats(qt, kt, k, v, n_valid=nv, l_valid=lv)[1], BmV)
    torch.cuda.synchronize()


def _both_kernels(g, dev, dtype, P, S, L, Dh, Dv, n_valid, l_valid, q_scale=1.0):
    """landmark_attention (S query rows over L keys, a bias lane with −1e30
    entries) and landmark_stats (L landmark rows over S keys, masked at
    n_valid and l_valid) against their plain versions, at the tolerances of
    the tests above, and every rows-a-block candidate against the static
    geometry bit for bit."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    q = (_randn(g, (P, S, Dh), dev) * q_scale).to(dtype)
    kt, M = _randn(g, (P, L, Dh), dev, dtype), _randn(g, (P, L, Dv), dev, dtype)
    bias = torch.log(torch.rand((P, L), generator=g) * 3 + 0.1)
    bias[:, ::5] = -1e30
    bias = bias.to(dev)
    out = LK.landmark_attention(q, kt, M, bias)
    assert out.isfinite().all()
    _close(out, LR.landmark_attention_ref(q, kt, M, bias), tol)
    fb = (LK.static_rows(S, Dh, dtype, dtype, dev),)
    _candidates_equal_static(lambda c: (LK.landmark_attention(q, kt, M, bias, bq=c[0]),),
                             LO._bq_candidates(S, fb, Dh, dtype, dtype, dev), fb)
    qt = (_randn(g, (P, L, Dh), dev) * q_scale).to(dtype)
    k, v = _randn(g, (P, S, Dh), dev, dtype), _randn(g, (P, S, Dv), dev, dtype)
    W, BmV = LK.landmark_stats(qt, kt, k, v, n_valid=n_valid, l_valid=l_valid)
    Wr, BmVr = LR.landmark_stats_ref(qt, kt, k, v, n_valid=n_valid, l_valid=l_valid)
    _close(W, Wr, 1e-5)
    _close(BmV, BmVr, 1e-5)
    fb = (LK.static_rows(L, Dh, dtype, torch.float32, dev, "landmark_stats"),)
    _candidates_equal_static(
        lambda c: LK.landmark_stats(qt, kt, k, v, n_valid=n_valid, l_valid=l_valid, bs=c[0]),
        LO._bq_candidates(L, fb, Dh, dtype, torch.float32, dev), fb)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", [63, 64, 65])
def test_cuda_landmark_tile_edges(cuda_device, edge, dtype):
    """S, L, n_valid and l_valid just below, at and just above the 64-key
    tile and a multiple of the 16-row warp tile: landmark_attention with
    ``edge`` query rows over ``edge`` keys; landmark_stats with ``edge``
    landmark rows over 128 + ``edge`` keys, masked from key ``edge`` and
    landmark column ``edge`` − 1."""
    g = torch.Generator().manual_seed(edge)
    _both_kernels(g, cuda_device, dtype, 3, edge, edge, 64, 72, edge, edge - 1)
    _both_kernels(g, cuda_device, dtype, 2, 128 + edge, edge, 32, 40, edge, edge)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [16, 80, 128, 256])
def test_cuda_landmark_head_dims(cuda_device, Dh, dtype):
    """Head dims from 16 to MAX_HEAD_DIM (256 takes 32-key tiles in
    float32), with Dv = 200 across two value chunks."""
    g = torch.Generator().manual_seed(Dh)
    _both_kernels(g, cuda_device, dtype, 2, 150, 100, Dh, 200, 93, 97)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_landmark_large_logits(cuda_device, dtype):
    """Queries scaled ×4 (logits of standard deviation 4 at Dh = 128), where
    an error of the split products would show through expf."""
    g = torch.Generator().manual_seed(44)
    _both_kernels(g, cuda_device, dtype, 4, 256, 1024, 128, 128, 250, 1000, q_scale=4.0)


@pytest.mark.cuda
def test_cuda_landmark_fits_at_head_dim_256(cuda_device):
    """At Dh = MAX_HEAD_DIM the tensor-core sweep launches at 64 rows a
    block in every dtype variant (float32 at 32-key tiles), and the decode
    sweep at its 8 rows."""
    for dtype, out in [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                       (torch.bfloat16, torch.float32)]:
        assert LK.fits(64, 256, dtype, out, cuda_device)
        assert LK.fits(8, 256, dtype, out, cuda_device)
    assert LK.key_tile(9, 256, torch.float32) == 32


@pytest.mark.cuda
def test_cuda_decode_sweep_is_one_launch_and_resets_its_counters(cuda_device):
    """The decode sweep combines its splits in the launch that computes
    them: one device operation a call, its own kernel, and every arrival
    counter back at 0 after it, whatever shape the previous call had."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(5)
    shapes = [(32, 4, 1024, 128, 128), (3, 1, 4097, 64, 200), (2, 8, 100, 256, 40)]
    for P, S, L, Dh, Dv in shapes:
        q, kt = _randn(g, (P, S, Dh), cuda_device), _randn(g, (P, L, Dh), cuda_device)
        M = _randn(g, (P, L, Dv), cuda_device)
        assert LK.plan(P, S, L, Dv, Dh, torch.float32)[0] > 1
        want = LK.landmark_attention(q, kt, M)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = LK.landmark_attention(q, kt, M)
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(ops) == 1 and "attend_decode_kernel" in ops[0], ops
        assert torch.equal(got, want)
        assert all(int(buf.count_nonzero()) == 0 for buf in LK._ARRIVALS.values())


@pytest.mark.cuda
def test_landmark_wrappers_route_cuda_tensors_to_the_kernels(cuda_device):
    """ops entry points, the decode attend and accum_attention launch the
    kernels once per call on CUDA tensors and agree with the plain routes."""
    from repro_torch.core.sketched_attention import (
        SketchCache, accum_attention, make_seq_sketch, sketch_decode_attend)

    g = torch.Generator().manual_seed(1)
    LK.reset_launches()
    q, kt, M = (_randn(g, s, cuda_device) for s in ((37, 16), (13, 16), (13, 8)))
    _close(LO.landmark_attend(q, kt, M), LR.landmark_attention_ref(q, kt, M), 1e-5)
    W, BmV = LO.landmark_stats_fused(kt, kt, q, _randn(g, (37, 8), cuda_device))
    assert LK.landmark_attention.launches == LK.landmark_stats.launches == 1
    cache = SketchCache(_randn(g, (2, 2, 24, 16), cuda_device),
                        _randn(g, (2, 2, 24, 16), cuda_device),
                        torch.rand((2, 2, 24), generator=g).to(cuda_device))
    qd = _randn(g, (2, 4, 16), cuda_device)
    _close(sketch_decode_attend(qd, cache), sketch_decode_attend(qd, cache, use_kernel=False),
           1e-5)
    assert LK.landmark_attention.launches == 2
    B, H, S, Dh = 1, 2, 256, 32
    qa, ka, va = (_randn(g, (B, H, S, Dh), cuda_device) for _ in range(3))
    sk = make_seq_sketch(torch.Generator().manual_seed(2), S, 32, 4, device=cuda_device)
    got = accum_attention(qa, ka, va, sk)
    assert LK.landmark_attention.launches == 3 and LK.landmark_stats.launches == 2
    _close(got, accum_attention(qa, ka, va, sk, use_kernel=False), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme", ["uniform", "poisson"])
def test_cuda_prefill_fold_bitwise_equals_sequential(cuda_device, dtype, scheme):
    """On the card the prefill cache is bitwise the token-by-token fold."""
    from repro_torch.core.sketched_attention import (
        decode_slot_table, init_sketch_cache, prefill_sketch_cache, update_sketch_cache)

    B, Hkv, d_slots, m_r, Dh, L = 2, 2, 16, 2, 8, 40
    table = decode_slot_table(0, L, d_slots, m_r, scheme=scheme)
    g = torch.Generator().manual_seed(3)
    k = _randn(g, (B, Hkv, L, Dh), cuda_device, dtype)
    v = _randn(g, (B, Hkv, L, Dh), cuda_device, dtype)
    seq = init_sketch_cache(B, Hkv, d_slots, Dh, dtype, device=cuda_device)
    bat = prefill_sketch_cache(seq, k, v, table)
    for t in range(L):
        seq = update_sketch_cache(seq, k[:, :, t], v[:, :, t], table[t])
    for x, y in zip(bat, seq):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_head_logits_float32_without_a_widened_head(cuda_device):
    """bfloat16 hidden state × bfloat16 head → float32 logits (not rounded
    to bfloat16), equal to the widened product up to float32 sum order."""
    from repro_torch.models.model import _head_logits

    g = torch.Generator().manual_seed(4)
    h = _randn(g, (3, 256), cuda_device, torch.bfloat16)
    emb = _randn(g, (1000, 256), cuda_device, torch.bfloat16)
    got = _head_logits(h, emb)
    assert got.dtype == torch.float32
    _close(got, h.float() @ emb.float().T, 1e-5)
