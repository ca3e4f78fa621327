"""The CUDA kernels against their plain versions, on the card.  The kernels
have no CPU mode, so these tests skip without a CUDA device; they import
neither JAX nor the reference, so they run where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import make_accum_sketch  # noqa: E402
from repro_torch.core.kernels_math import get_kernel  # noqa: E402
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
    assert [f.launches for f in KT.KERNELS] == [1] * 6
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


# --------------------------------------------------------------------------- #
# the landmark-attention kernels
# --------------------------------------------------------------------------- #

def _randn(g, shape, dev, dtype=torch.float32):
    return torch.randn(shape, generator=g).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,S,L,Dh,Dv", [(6, 4, 100, 32, 32), (3, 130, 77, 16, 24),
                                         (2, 70, 40, 64, 200), (4, 1, 1024, 128, 128),
                                         (2, 300, 33, 80, 80)])
def test_cuda_landmark_attention_matches_plain(cuda_device, P, S, L, Dh, Dv, dtype):
    """Odd S and L (the kernel masks its ragged edges), Dv above one value
    tile, the decode shape with a bias lane mixing log-mass with −1e30, and
    a row whose every landmark is masked (uniform weights, no NaN).  float32
    at 1e-5 of max|plain| (sum order only); bfloat16 output at 2e-2 (one
    rounding of the output)."""
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
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,L,S,Dh,Dv,nv,lv", [(3, 50, 300, 16, 24, 270, 45),
                                               (2, 130, 2049, 64, 64, 2049, 130),
                                               (1, 7, 5, 8, 5, 3, 2)])
def test_cuda_landmark_stats_matches_plain(cuda_device, P, L, S, Dh, Dv, nv, lv, dtype):
    """W and BmV with keys ≥ n_valid and landmark columns ≥ l_valid masked,
    against the plain version with the same masks: float32 sums, held at
    1e-5 of max|plain| (bfloat16 inputs are widened exactly, so the same)."""
    g = torch.Generator().manual_seed(P + L + S)
    qt, kt = _randn(g, (P, L, Dh), cuda_device, dtype), _randn(g, (P, L, Dh), cuda_device, dtype)
    k, v = _randn(g, (P, S, Dh), cuda_device, dtype), _randn(g, (P, S, Dv), cuda_device, dtype)
    W, BmV = LK.landmark_stats(qt, kt, k, v, n_valid=nv, l_valid=lv)
    Wr, BmVr = LR.landmark_stats_ref(qt, kt, k, v, n_valid=nv, l_valid=lv)
    assert W.dtype == BmV.dtype == torch.float32
    _close(W, Wr, 1e-5)
    _close(BmV, BmVr, 1e-5)
    torch.cuda.synchronize()


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
