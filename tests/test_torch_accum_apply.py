"""Port parity for the accum_apply kernel family: each ``ops`` wrapper of the
port, on CPU tensors (where it takes its kernel's plain version), held
against both the JAX ``ref.py`` oracle and the JAX Pallas wrapper (interpret
mode on the CPU), with the reference tests' shape sweeps and tolerances
(tests/test_matfree.py, tests/test_kernels.py).  The CUDA kernels themselves
are held against the plain versions in test_torch_cuda_kernels.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.kernel_op import stream_cols  # noqa: E402
from repro.core.kernels_math import get_kernel as get_kernel_jax  # noqa: E402
from repro.core.sketch import make_accum_sketch  # noqa: E402
from repro.kernels.accum_apply import ops as OJ  # noqa: E402
from repro.kernels.accum_apply import ref as RJ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.kernels_math import get_kernel  # noqa: E402
from repro_torch.kernels.accum_apply import ops as OT  # noqa: E402
from repro_torch.kernels.accum_apply import ref as RT  # noqa: E402

KEY = jax.random.PRNGKey(0)
# the reference sweep's kernels (tests/test_matfree.py:26, :42)
KERNELS = [("gaussian", 0.6, 1.5), ("laplacian", 1.0, 1.5), ("matern", 0.8, 1.5),
           ("matern", 0.8, 2.5)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _sketch(n, d, m, salt):
    skj = make_accum_sketch(jax.random.fold_in(KEY, salt), n, d, m)
    return skj, interop.sketch_from_numpy(np.asarray(skj.indices),
                                          np.asarray(skj.signs),
                                          np.asarray(skj.probs), n, device="cpu")


def _pair(a32: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor in ``dtype`` (both
    round float32 to bfloat16 to nearest even)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a32).astype(jd), torch.from_numpy(a32).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


# --------------------------------------------------------------------------- #
# matfree_apply (AA:474)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel,bw,nu", KERNELS)
@pytest.mark.parametrize("n,p,d,m", [(200, 3, 10, 3), (256, 8, 16, 4),
                                     (100, 5, 7, 1), (173, 4, 9, 3)])
def test_matfree_cols_kernel_parity(n, p, d, m, kernel, bw, nu, dtype):
    rng = np.random.default_rng(n + d)
    Xj, Xt = _pair(rng.normal(size=(n, p)).astype(np.float32), dtype)
    skj, skt = _sketch(n, d, m, m)
    Lt = Xt.index_select(0, skt.indices.reshape(-1))
    out = OT.matfree_cols_kernel(Xt, Lt, skt.coef, kernel=kernel, bandwidth=bw,
                                 nu=nu)
    assert out.dtype == torch.float32 and out.shape == (n, d)
    oracle = RJ.matfree_cols_ref(Xj.astype(jnp.float32), skj.indices, skj.coef,
                                 get_kernel_jax(kernel, bw, nu))
    Lj = jnp.take(Xj, skj.indices.reshape(-1), axis=0)
    pallas = OJ.matfree_cols_kernel(Xj, Lj, skj.coef, kernel=kernel,
                                    bandwidth=bw, nu=nu)
    tol = 1e-5 if dtype == "float32" else 5e-2
    cusp = np.zeros((n, d), bool)
    if kernel == "laplacian" and dtype == "float32":
        # Entry (r, j) meets the Laplacian's cusp when row r is one of
        # column j's landmarks: there the expanded distance a²+b²−2ab leaves
        # float32 rounding noise that √ lifts to ~1e-3 (ROADMAP queue 3; the
        # reference's own Pallas-vs-oracle test fails there by 3.6e-3).  Each
        # library sums a·b in its own order, so only those entries get the
        # self-pair allowance; every other entry holds the reference's 1e-5.
        cusp[np.asarray(skj.indices).reshape(-1), np.tile(np.arange(d), m)] = True
    for theirs in (oracle, pallas):
        np.testing.assert_allclose(out.numpy()[~cusp], _np(theirs)[~cusp],
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(out.numpy()[cusp], _np(theirs)[cusp],
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kernel,bw,nu", KERNELS)
def test_matfree_plain_f64_matches_reference_oracle(kernel, bw, nu):
    """The algorithm itself, in float64 on both sides: the port's oracle
    against the reference's float64 streaming path (its ``matfree_cols_ref``
    casts the slab to float32)."""
    n, p, d, m = 200, 3, 10, 3
    X = np.random.default_rng(1).normal(size=(n, p))
    skj, skt = _sketch(n, d, m, 11)
    with jax.enable_x64(True):
        Xj = jnp.asarray(X)
        ref = np.asarray(stream_cols(
            Xj, jnp.take(Xj, skj.indices.reshape(-1), axis=0),
            jnp.asarray(np.asarray(skj.coef), jnp.float64),
            get_kernel_jax(kernel, bw, nu)))
    assert ref.dtype == np.float64
    coef = torch.from_numpy(np.asarray(skj.coef)).double()
    out = RT.matfree_cols_ref(torch.from_numpy(X), skt.indices, coef,
                              get_kernel(kernel, bw, nu))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-10)


# --------------------------------------------------------------------------- #
# accum_apply_left (AA:229)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("N,d,m,c", [(256, 8, 1, 16), (512, 32, 4, 32),
                                     (300, 12, 3, 7), (128, 19, 2, 5)])
def test_sketch_left_kernel_parity(N, d, m, c, dtype):
    skj, skt = _sketch(N, d, m, N + d + m)
    Mj, Mt = _pair(np.random.default_rng(c).normal(size=(N, c)).astype(np.float32),
                   dtype)
    out = OT.sketch_left_kernel(skt, Mt)
    assert out.dtype == torch.float32 and out.shape == (d, c)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(out.numpy(),
                               _np(RJ.sketch_left_ref(skj.indices, skj.coef, Mj)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(out.numpy(), _np(OJ.sketch_left_kernel(skj, Mj)),
                               rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# accum_sketch_both (AA:164)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,d,m", [(128, 8, 1), (256, 32, 4), (128, 16, 8),
                                   (256, 64, 2), (400, 19, 4)])
def test_sketch_both_kernel_parity(n, d, m, dtype):
    K = np.random.default_rng(n).normal(size=(n, n)).astype(np.float32)
    Kj, Kt = _pair(0.5 * (K + K.T), dtype)
    skj, skt = _sketch(n, d, m, n + d * m)
    C, W = OT.sketch_both_kernel(Kt, skt)
    assert C.dtype == Kt.dtype and W.dtype == torch.float32
    assert C.shape == (n, d) and W.shape == (d, d)
    tol = 1e-4 if dtype == "float32" else 3e-2
    Cr, Wr = RJ.sketch_both_ref(Kj, skj.indices, skj.coef.astype(jnp.float32))
    Cp, Wp = OJ.sketch_both_kernel(Kj, skj, bm=64, bn=128)
    for Cj, Wj in ((Cr, Wr), (Cp, Wp)):
        np.testing.assert_allclose(_np(C), _np(Cj), rtol=tol, atol=tol)
        np.testing.assert_allclose(W.numpy(), _np(Wj), rtol=tol, atol=tol)


def test_sketch_both_kernel_refuses_rectangular():
    _, skt = _sketch(64, 4, 2, 5)
    with pytest.raises(ValueError):
        OT.sketch_both_kernel(torch.zeros(64, 80), skt)
