"""Port parity for approximate matrix multiplication (``core/amm.py``) and the
K-satisfiability certificate (``core/ksat.py``): the reference's draws
carried across (``interop.sketch_from_numpy``), ``amm``/``amm_error`` to
1e-5 relative in float32 and ``ksat_check``'s four fields to 1e-8 in
float64 on the reference's data (tests/test_amm_and_attention.py,
tests/test_krr.py ``_toy``, whose spectrum is separated at the cut d_δ);
then the reference's statistical claims on the port's own draws."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import amm as amm_j  # noqa: E402
from repro.core import amm_error as amm_error_j  # noqa: E402
from repro.core import ksat_check as ksat_j  # noqa: E402
from repro.core.kernels_math import get_kernel as get_kernel_j  # noqa: E402
from repro.core.leverage import d_delta as d_delta_j  # noqa: E402
from repro.core.leverage import spectrum as spectrum_j  # noqa: E402
from repro.core.sketch import make_accum_sketch as sketch_j  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import (  # noqa: E402
    amm,
    amm_error,
    get_kernel,
    ksat_check,
    make_accum_sketch,
)
from repro_torch.core.leverage import d_delta, spectrum  # noqa: E402

KEY_AMM = jax.random.PRNGKey(3)      # tests/test_amm_and_attention.py
KEY_KRR = jax.random.PRNGKey(7)      # tests/test_krr.py


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(skj, n):
    return interop.sketch_from_numpy(np.asarray(skj.indices), np.asarray(skj.signs),
                                     np.asarray(skj.probs), n,
                                     coef=np.asarray(skj.coef), device="cpu")


def _amm_data(n=256, p=8, q=6):
    A = jax.random.normal(KEY_AMM, (n, p))
    B = jax.random.normal(jax.random.fold_in(KEY_AMM, 1), (n, q))
    return A, B


def _toy(n):
    """tests/test_krr.py ``_toy``: the paper's bimodal distribution over R³."""
    k1, k2, _, _ = jax.random.split(KEY_KRR, 4)
    n2 = max(int(n**0.6 * n / (n + n**0.6)), 8)
    x1 = jax.random.uniform(k1, (n - n2, 3))
    x2 = 2.0 + 0.5 * jax.random.beta(k2, 1.0, 2.0, (n2, 3))
    return jnp.concatenate([x1, x2])


# --------------------------------------------------------------------------- #
# amm: the reference's draws, float32, 1e-5 relative
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("d,m", [(16, 2), (64, 2), (128, 2), (64, 8)])
def test_amm_matches_reference(d, m):
    n = 256
    A, B = _amm_data(n)
    skj = sketch_j(jax.random.fold_in(KEY_AMM, 500 + d + m), n, d, m)
    sk = _carry(skj, n)
    ref = np.asarray(amm_j(A, B, skj))
    out = amm(_t(A), _t(B), sk)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref) < 1e-5
    e_ref = float(amm_error_j(A, B, skj))
    np.testing.assert_allclose(float(amm_error(_t(A), _t(B), sk)), e_ref, rtol=1e-5)


def test_amm_unbiased_and_converges():
    """The reference's case on the port's own draws: the mean of 200
    sketched products is near AᵀB, and the error shrinks as d grows."""
    n = 256
    A, B = (_t(x) for x in _amm_data(n))
    exact = A.T @ B
    g = torch.Generator().manual_seed(3)
    acc = sum(amm(A, B, make_accum_sketch(g, n, 64, 2, device="cpu")) for _ in range(200))
    assert float((acc / 200 - exact).norm() / exact.norm()) < 0.2
    errs = {d: np.mean([float(amm_error(A, B, make_accum_sketch(g, n, d, 2, device="cpu")))
                        for _ in range(10)]) for d in (16, 128)}
    assert errs[128] < errs[16]


# --------------------------------------------------------------------------- #
# ksat_check: the reference's draws, float64, 1e-8
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("m,salt", [(1, 0), (1, 1), (16, 0), (16, 1)])
def test_ksat_check_matches_reference(m, salt, dense):
    n, delta = 250, 1e-3
    with jax.enable_x64(True):
        X = jnp.asarray(np.asarray(_toy(n)), jnp.float64)
        Kj = get_kernel_j("gaussian", bandwidth=0.75)(X, X)
        spec_j = spectrum_j(Kj)
        d = 4 * max(d_delta_j(spec_j, delta), 1)
        skj = sketch_j(jax.random.fold_in(KEY_KRR, 31 * m + salt), n, d, m,
                       dtype=jnp.float64)
        ref = ksat_j(Kj, skj.dense() if dense else skj, delta, spec_j)
        ref = [np.asarray(x) for x in ref]
        K = _t(Kj)
    spec = spectrum(K)
    assert d == 4 * max(d_delta(spec, delta), 1)
    sk = _carry(skj, n)
    out = ksat_check(K, sk.dense() if dense else sk, delta, spec)
    for got, want in zip(out[:3], ref[:3]):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)
    assert bool(out.satisfied) == bool(ref[3])


def test_ksat_improves_with_m():
    """tests/test_krr.py's trend on the port's own draws: accumulation
    shrinks ‖U₁ᵀSSᵀU₁ − I‖."""
    n, delta = 250, 1e-3
    X = _t(_toy(n)).double()
    K = get_kernel("gaussian", 0.75)(X, X)
    spec = spectrum(K)
    d = 4 * max(d_delta(spec, delta), 1)
    g = torch.Generator().manual_seed(31)
    devs = {m: np.mean([float(ksat_check(
        K, make_accum_sketch(g, n, d, m, dtype=torch.float64, device="cpu"), delta,
        spec).top_deviation) for _ in range(5)]) for m in (1, 16)}
    assert devs[16] < devs[1]
