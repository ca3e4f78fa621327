"""Port parity for the slice as a whole: sketched KRR fit and predict in
repro_torch against repro on the same numpy data and the same JAX sketch
draw.  Float64 runs are held at rtol 1e-7; float32 runs compare θ through
the relative residual of the reference's d×d Woodbury system, since the
reference's own float32 spread at small m is 7.7e-4 (ROADMAP queue 3)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import apply as AJ  # noqa: E402
from repro.core import krr as KJ  # noqa: E402
from repro.core.kernel_op import KernelOperator as OpJ  # noqa: E402
from repro.core.kernels_math import get_kernel as get_kernel_jax  # noqa: E402
from repro.core.sketch import make_accum_sketch, make_nystrom_sketch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import krr as KT  # noqa: E402
from repro_torch.core.kernel_op import KernelOperator as OpT  # noqa: E402
from repro_torch.core.kernels_math import get_kernel  # noqa: E402

KEY = jax.random.PRNGKey(0)
LAM = 1e-3
BW = 0.5


def _problem(n, seed, dtype):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 3))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - X[:, 2] + 0.3 * rng.normal(size=n)
    return X.astype(dtype), y.astype(dtype)


def _draw(n, d, m, dtype, salt=0, nystrom=False):
    key = jax.random.fold_in(KEY, salt)
    skj = (make_nystrom_sketch(key, n, d, dtype=dtype) if nystrom
           else make_accum_sketch(key, n, d, m, dtype=dtype))
    skt = interop.sketch_from_numpy(np.asarray(skj.indices), np.asarray(skj.signs),
                                    np.asarray(skj.probs), n,
                                    coef=np.asarray(skj.coef), device="cpu")
    return skj, skt


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(out, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


# --------------------------------------------------------------------------- #
# float64: every route, fitted values and predictions at rtol 1e-7
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("route", ["matfree_raw", "operator", "dense", "pcg"])
def test_sketched_fit_f64(route):
    n, d, m = 600, 30, 4
    X, y = _problem(n, 1, np.float64)
    Xq = _problem(50, 2, np.float64)[0]
    with jax.enable_x64(True):
        skj, skt = _draw(n, d, m, jnp.float64, salt=1)
        Xj, yj = jnp.asarray(X), jnp.asarray(y)
        kfj, kft = get_kernel_jax("gaussian", BW), get_kernel("gaussian", BW)
        if route == "matfree_raw":
            mj = KJ.krr_sketched_fit_matfree(Xj, yj, LAM, skj, kfj)
            mt = KT.krr_sketched_fit_matfree(_t(X), _t(y), LAM, skt, kft)
        elif route == "operator":
            mj = KJ.krr_sketched_fit(OpJ(Xj, "gaussian", BW), yj, LAM, skj)
            mt = KT.krr_sketched_fit(OpT(_t(X), "gaussian", BW), _t(y), LAM, skt)
        elif route == "dense":
            K = np.asarray(kfj(Xj, Xj))
            mj = KJ.krr_sketched_fit(jnp.asarray(K), yj, LAM, skj, Xj, kfj)
            mt = KT.krr_sketched_fit(_t(K), _t(y), LAM, skt, _t(X), kft)
        else:
            mj = KJ.krr_sketched_fit_pcg(Xj, yj, LAM, skj, kfj, iters=30)
            mt = KT.krr_sketched_fit_pcg(_t(X), _t(y), LAM, skt, kft, iters=30)
        pj = mj.predict(jnp.asarray(Xq))
        fj = mj.fitted
    assert mt.fitted.dtype == torch.float64
    _close(mt.fitted, fj, 1e-7)
    _close(mt.predict(_t(Xq)), pj, 1e-7)


@pytest.mark.parametrize("kernel,nu", [("laplacian", 1.5), ("matern", 2.5)])
def test_operator_fit_f64_other_kernels(kernel, nu):
    n, d, m = 400, 20, 3
    X, y = _problem(n, 3, np.float64)
    with jax.enable_x64(True):
        skj, skt = _draw(n, d, m, jnp.float64, salt=3)
        mj = KJ.krr_sketched_fit(OpJ(jnp.asarray(X), kernel, 0.8, nu),
                                 jnp.asarray(y), LAM, skj)
        pj = mj.predict(jnp.asarray(X[:40] + 0.01))
        fj = mj.fitted
    mt = KT.krr_sketched_fit(OpT(_t(X), kernel, 0.8, nu), _t(y), LAM, skt)
    _close(mt.fitted, fj, 1e-7)
    _close(mt.predict(_t(X[:40] + 0.01)), pj, 1e-7)


def test_exact_fitted_f64():
    X, y = _problem(500, 4, np.float64)
    with jax.enable_x64(True):
        K = get_kernel_jax("gaussian", BW)(jnp.asarray(X), jnp.asarray(X))
        fj = KJ.krr_exact_fitted(K, jnp.asarray(y), LAM)
        K = np.asarray(K)
    _close(KT.krr_exact_fitted(_t(K), _t(y), LAM), fj, 1e-7)


# --------------------------------------------------------------------------- #
# float32: the kernel routes' plain versions (use_kernel=True on the CPU),
# θ held through the relative residual of the reference's d×d system
# --------------------------------------------------------------------------- #

def _woodbury_residual(C, W, y, theta, n):
    C, W, y, theta = (np.asarray(a, np.float64) for a in (C, W, y, theta))
    M = C.T @ C + n * LAM * W
    rhs = C.T @ y
    return np.linalg.norm(M @ theta - rhs) / np.linalg.norm(rhs)


@pytest.mark.parametrize("route", ["matfree_raw", "operator", "dense"])
@pytest.mark.parametrize("n,d,m", [(300, 16, 1), (1000, 40, 4)])
def test_sketched_fit_f32_residual(route, n, d, m):
    X, y = _problem(n, 5, np.float32)
    skj, skt = _draw(n, d, m, jnp.float32, salt=n + m)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    kfj = get_kernel_jax("gaussian", BW)
    if route == "matfree_raw":
        Cj = AJ.sketch_kernel_cols(Xj, skj, kfj)
        Wj = AJ.sketch_left(skj, Cj)
        Wj = 0.5 * (Wj + Wj.T)
        mt = KT.krr_sketched_fit_matfree(_t(X), _t(y), LAM, skt,
                                         get_kernel("gaussian", BW),
                                         use_kernel=True)
    elif route == "operator":
        Cj, Wj = OpJ(Xj, "gaussian", BW).sketch_both(skj)
        mt = KT.krr_sketched_fit(OpT(_t(X), "gaussian", BW), _t(y), LAM, skt,
                                 use_kernel=True)
    else:
        K = np.asarray(kfj(Xj, Xj))
        Cj, Wj = AJ.sketch_both(jnp.asarray(K), skj)
        mt = KT.krr_sketched_fit(_t(K), _t(y), LAM, skt, use_kernel=True)
    assert mt.theta.dtype == torch.float32
    res = _woodbury_residual(Cj, Wj, y, mt.theta.numpy(), n)
    assert res <= 1e-4, res
    assert not mt.info["solve_used_lstsq"]


def test_pcg_f32_matches_reference():
    n, d, m = 800, 32, 4
    X, y = _problem(n, 6, np.float32)
    skj, skt = _draw(n, d, m, jnp.float32, salt=9)
    mj = KJ.krr_sketched_fit_pcg(OpJ(jnp.asarray(X), "gaussian", BW),
                                 jnp.asarray(y), LAM, skj, iters=30)
    mt = KT.krr_sketched_fit_pcg(OpT(_t(X), "gaussian", BW), _t(y), LAM, skt,
                                 iters=30, use_kernel=True)
    _close(mt.fitted, mj.fitted, 1e-3)


# --------------------------------------------------------------------------- #
# interop and the quickstart claim
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("x64", [False, True])
def test_krr_from_numpy_predicts_like_jax(x64):
    n, d, m = 700, 24, 3
    dt = np.float64 if x64 else np.float32
    X, y = _problem(n, 7, dt)
    Xq = _problem(64, 8, dt)[0]
    with jax.enable_x64(x64):
        skj, _ = _draw(n, d, m, jnp.dtype(dt), salt=7)
        mj = KJ.krr_sketched_fit(OpJ(jnp.asarray(X), "matern", 0.7, 1.5),
                                 jnp.asarray(y), LAM, skj)
        pj = mj.predict(jnp.asarray(Xq))
        mt = interop.krr_from_numpy(
            np.asarray(mj.theta), np.asarray(skj.indices), np.asarray(skj.signs),
            np.asarray(skj.probs), X, "matern", 0.7, 1.5, device="cpu")
    _close(mt.predict(_t(Xq)), pj, 1e-10 if x64 else 1e-5)


def test_quickstart_claim_both_packages():
    """quickstart §1 on its own data (n=2000, d=40): on the same JAX draws,
    accumulation m=8 is closer to exact KRR than Nyström m=1, in the
    reference and in the port.  A single draw does not order the two — at
    the quickstart's key 0 the reference itself gives Nyström 3.5e-5 against
    accumulation 6.6e-5 in float32 (ROADMAP queue 3) — so the claim is held
    on the median over 8 draws.  The fits run in float64, where each draw's
    error is held across packages at rtol 1e-6 (in float32 the ill-conditioned
    Woodbury solve spreads them by tens of percent in either package)."""
    n, d, draws = 2000, 40, 8
    key = jax.random.PRNGKey(0)
    Xj = jax.random.uniform(key, (n, 3))
    yj = (jnp.sin(3 * Xj[:, 0]) + Xj[:, 1] ** 2 - Xj[:, 2]
          + 0.3 * jax.random.normal(jax.random.fold_in(key, 1), (n,)))
    X, y = np.asarray(Xj, np.float64), np.asarray(yj, np.float64)
    errs = {"nystrom": ([], []), "accum": ([], [])}
    kft = get_kernel("gaussian", BW)
    exact_t = KT.krr_exact_fitted(kft(_t(X), _t(X)), _t(y), LAM)
    with jax.enable_x64(True):
        Xj, yj = jnp.asarray(X), jnp.asarray(y)
        kfj = get_kernel_jax("gaussian", BW)
        exact_j = KJ.krr_exact_fitted(kfj(Xj, Xj), yj, LAM)
        for i in range(draws):
            for name, nystrom, m in [("nystrom", True, 1), ("accum", False, 8)]:
                skj, skt = _draw(n, d, m, jnp.float64, salt=i, nystrom=nystrom)
                fj = KJ.krr_sketched_fit_matfree(Xj, yj, LAM, skj, kfj).fitted
                ft = KT.krr_sketched_fit_matfree(_t(X), _t(y), LAM, skt,
                                                 kft).fitted
                errs[name][0].append(float(KJ.insample_error(fj, exact_j)))
                errs[name][1].append(float(KT.insample_error(ft, exact_t)))
    for pkg in (0, 1):
        assert np.median(errs["accum"][pkg]) < np.median(errs["nystrom"][pkg])
    for ej, et in errs.values():
        np.testing.assert_allclose(et, ej, rtol=1e-6)
