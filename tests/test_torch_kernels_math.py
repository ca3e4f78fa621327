"""Port parity: repro_torch.core.kernels_math against repro.core.kernels_math
on the same numpy inputs (gaussian in float32; the Laplacian and Matérn cusp
forms in float64, where the reference's own float32 self-pair error does not
enter)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kernels_math as KJ  # noqa: E402
from repro_torch.core import kernels_math as KT  # noqa: E402

CUSP_FORMS = [("laplacian", 1.5), ("matern", 0.5), ("matern", 1.5),
              ("matern", 2.5)]


def _data(dtype, n=41, m=23, p=4, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, p)).astype(dtype)
    B = rng.normal(size=(m, p)).astype(dtype)
    B[:5] = A[:5]          # exact self-pairs: the cusp of the expanded form
    return A, B


@pytest.mark.parametrize("bw", [0.5, 1.3])
def test_gaussian_f32(bw):
    A, B = _data(np.float32)
    ref = np.asarray(KJ.gaussian_kernel(jnp.asarray(A), jnp.asarray(B), bw))
    out = KT.gaussian_kernel(torch.from_numpy(A), torch.from_numpy(B), bw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bw", [0.7, 1.3])
@pytest.mark.parametrize("name,nu", CUSP_FORMS)
def test_cusp_forms_f64(name, nu, bw):
    A, B = _data(np.float64)
    with jax.enable_x64(True):
        ref = np.asarray(KJ.get_kernel(name, bw, nu)(jnp.asarray(A),
                                                     jnp.asarray(B)))
    assert ref.dtype == np.float64
    out = KT.get_kernel(name, bw, nu)(torch.from_numpy(A), torch.from_numpy(B))
    assert out.dtype == torch.float64
    # away from the cusp the two agree to 1e-10; at the exact self-pairs the
    # expanded distance leaves rounding noise of order eps·|a|² (summed in
    # another order by each library) and the square root lifts it to
    # √eps ≈ 1.5e-8 — the reference's self-pair fault (ROADMAP queue 3) in
    # float64
    self_pair = (A[:, None, :] == B[None, :, :]).all(-1)
    out = out.numpy()
    np.testing.assert_allclose(out[~self_pair], ref[~self_pair], rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(out[self_pair], ref[self_pair], rtol=1e-7,
                               atol=1e-7)


def test_expanded_distance_clamps_at_zero():
    """The expanded a²+b²−2ab can round below 0; the clamp keeps every
    kernel value ≤ 1 and finite, as in the reference."""
    A, _ = _data(np.float32, n=64, p=3)
    At = torch.from_numpy(A * 10)
    for name, nu in [("gaussian", 1.5)] + CUSP_FORMS:
        K = KT.get_kernel(name, 0.9, nu)(At, At)
        assert torch.isfinite(K).all() and float(K.max()) <= 1.0


def test_get_kernel_cached_and_validated():
    assert KT.get_kernel("gaussian", 0.5) is KT.get_kernel("gaussian", 0.5)
    assert KT.get_kernel("matern", 1, 2.5) is KT.get_kernel("matern", 1.0, 2.5)
    with pytest.raises(ValueError):
        KT.get_kernel("cauchy")
    A, B = _data(np.float32)
    with pytest.raises(ValueError):
        KT.get_kernel("matern", 1.0, 2.0)(torch.from_numpy(A), torch.from_numpy(B))
