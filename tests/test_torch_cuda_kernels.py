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
    OT.sketch_both_kernel(get_kernel("gaussian", 0.5)(X, X), sk)
    assert [f.launches for f in KT.KERNELS] == [1, 1, 1]
    # the same calls on bad input raise instead of falling back
    with pytest.raises(TypeError):
        OT.sketch_left_kernel(sk, C.double())
    assert KT.accum_apply_left.launches == 1
