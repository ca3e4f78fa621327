"""Port parity for the sampling schemes and the leverage oracle: the Poisson
slabs and the leverage tail redraw on the reference's own random numbers
(``poisson_select``, ``replace_tail``), the sketch-estimated leverage
against the exact O(n³) oracle with the reference test's criteria
(tests/test_schemes.py), and the oracle itself against the reference in
float64."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import apply as AJ  # noqa: E402
from repro.core import leverage as LJ  # noqa: E402
from repro.core import schemes as SJ  # noqa: E402
from repro.core.kernels_math import gaussian_kernel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import apply as AT  # noqa: E402
from repro_torch.core import leverage as LT  # noqa: E402
from repro_torch.core import schemes as ST  # noqa: E402
from repro_torch.core.sketch import make_accum_sketch  # noqa: E402

KEY = jax.random.PRNGKey(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _state(stj):
    return interop.state_from_numpy(np.asarray(stj.indices), np.asarray(stj.signs),
                                    np.asarray(stj.probs), np.asarray(stj.pdraw),
                                    stj.n, device="cpu", scheme=stj.scheme)


def _leverage_problem(n=128):
    X = jax.random.normal(jax.random.PRNGKey(3), (n, 2))
    return gaussian_kernel(X, X, 0.8)


# --------------------------------------------------------------------------- #
# Poisson slabs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("n,d,m,nonuniform", [(200, 16, 4, False), (64, 24, 6, True),
                                              (500, 8, 3, True)])
def test_poisson_select_matches_reference(n, d, m, nonuniform, signed):
    """Given the reference's uniforms and signs, the same slabs: indices
    (overflow subsets and padding included) and Horvitz–Thompson signs."""
    key = jax.random.fold_in(KEY, n + d)
    probs = (np.random.default_rng(n).uniform(0.05, 3.0, n).astype(np.float32)
             if nonuniform else None)
    pi_j = SJ.poisson_inclusion(None if probs is None else jnp.asarray(probs), n, d)
    idx_j, sgn_j = SJ.poisson_pieces(key, pi_j, m, d, signed=signed)
    ku, ks = jax.random.split(key)
    u = _t(jax.random.uniform(ku, (m, n)))
    sgn = (_t(jax.random.rademacher(ks, (m, d), dtype=jnp.float32)) if signed
           else torch.ones((m, d)))
    pi_t = ST.poisson_inclusion(probs, n, d)
    np.testing.assert_allclose(pi_t.numpy(), np.asarray(pi_j), rtol=1e-6)
    idx_t, sgn_t = ST.poisson_select(u, sgn, pi_t, d)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(sgn_t.numpy(), np.asarray(sgn_j), rtol=1e-6)


def test_poisson_sketch_normalization():
    """The port's own Poisson draw: signs in {0, ±√(N/kept)}, coef 0 on
    padding, the Horvitz–Thompson coef r/√(m·π) elsewhere."""
    n, d, m = 60, 16, 12
    probs = np.linspace(1.0, 3.0, n)
    sk = make_accum_sketch(torch.Generator().manual_seed(2), n, d, m,
                           probs=probs, scheme="poisson", device="cpu")
    signs, coef = sk.signs.numpy(), sk.coef.numpy()
    assert (np.abs(signs[signs != 0]) >= 1.0 - 1e-6).all()
    assert (signs == 0).any() and (coef[signs == 0] == 0).all()
    assert np.isfinite(coef).all()
    pi = ST.poisson_inclusion(probs, n, d).numpy()
    idx = sk.indices.numpy()
    live = signs != 0
    np.testing.assert_allclose(np.abs(coef[live]),
                               np.abs(signs[live]) / np.sqrt(m * pi[idx[live]]),
                               rtol=1e-5)


def test_poisson_engine_matches_sketch_both():
    n, d = 150, 8
    X = torch.rand((n, 3), generator=torch.Generator().manual_seed(1))
    K = torch.exp(-torch.cdist(X, X) ** 2 / 0.5)
    sk, C, W, info = AT.grow_sketch_both(4, K, d, m_max=6, scheme="poisson",
                                         use_kernel=False)
    assert sk.scheme == "poisson" and info["passes"] == 1
    C2, W2 = AT.sketch_both(K, sk, use_kernel=False)
    np.testing.assert_allclose(C.numpy(), C2.numpy(), atol=1e-4)
    np.testing.assert_allclose(W.numpy(), W2.numpy(), atol=1e-4)


# --------------------------------------------------------------------------- #
# the leverage tail redraw
# --------------------------------------------------------------------------- #

def test_replace_tail_matches_reference_refresh():
    """On the reference's redraw, the same refreshed state: head slabs kept
    with their at-draw probabilities, tail replaced and re-weighted."""
    n, d, m_max = 128, 8, 6
    K = _leverage_problem(n)
    stj = AJ.accum_grow_batched(K, AJ.accum_init(KEY, n, d, m_max, scheme="leverage"),
                                3, use_kernel=False, donate=False)
    p_new = SJ.state_leverage_probs(stj, 1e-2, mix=0.1)
    key = jax.random.fold_in(KEY, 0x11E7)
    ref = SJ.refresh_tail(stj, key, p_new)
    kidx, ksgn = jax.random.split(key)
    idx_f = _t(jax.random.choice(kidx, n, shape=(m_max, d), replace=True, p=p_new))
    sgn_f = _t(jax.random.rademacher(ksgn, (m_max, d), dtype=jnp.float32))
    st = AT.accum_grow_batched(_t(K), _state(stj), 3, use_kernel=False)
    p_t = ST.state_leverage_probs(st, 1e-2, mix=0.1)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_new), rtol=1e-4, atol=1e-7)
    got = ST.replace_tail(st, idx_f, sgn_f, _t(p_new))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(got.signs.numpy(), np.asarray(ref.signs))
    np.testing.assert_allclose(got.pdraw.numpy(), np.asarray(ref.pdraw), rtol=1e-6)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(ref.probs), rtol=1e-6)
    # the port's own redraw keeps the head and draws the tail from p_t
    own = ST.refresh_tail(st, torch.Generator().manual_seed(0), p_t)
    assert torch.equal(own.indices[:3], st.indices[:3])
    assert torch.equal(own.pdraw[:3], st.pdraw[:3])
    np.testing.assert_allclose(own.pdraw[3:].numpy(),
                               p_t[own.indices[3:].long()].numpy(), rtol=1e-6)


def test_leverage_engine_refines_between_batches():
    n, d = 128, 8
    K = _t(_leverage_problem(n))
    sk, C, W, info = AT.grow_sketch_both(0, K, d, m_max=7, scheme="leverage",
                                         scheme_lam=1e-2, use_kernel=False)
    assert info["m"] == 7 and info["passes"] == len(AT.doubling_schedule(0, 7))
    assert sk.scheme == "leverage"
    C2, W2 = AT.sketch_both(K, sk, use_kernel=False)
    assert (C - C2).norm() / C2.norm() < 1e-5 and (W - W2).norm() / W2.norm() < 1e-5
    with pytest.raises(ValueError, match="doubling"):
        AT.grow_sketch_both(0, K, d, m_max=2, tol=0.1, scheme="leverage",
                            schedule="unit")


# --------------------------------------------------------------------------- #
# sketch-estimated leverage against the exact oracle
# --------------------------------------------------------------------------- #

def test_sketch_leverage_converges_to_exact():
    """TV(ℓ̂, ℓ) shrinks as the sketch grows and ends below 0.05, on the
    reference's draws (tests/test_schemes.py), and ℓ̂ matches the
    reference's estimate."""
    n, lam = 128, 1e-2
    K = _leverage_problem(n)
    exact = LT.leverage_probs(_t(K).double(), lam).numpy()
    tvs = []
    for d, m in [(8, 2), (16, 8), (32, 32)]:
        stj = AJ.accum_init(jax.random.PRNGKey(7), n, d, m)
        stj = AJ.accum_grow_batched(K, stj, m, use_kernel=False)
        st = AT.accum_grow_batched(_t(K), _state(stj), m, use_kernel=False)
        est = ST.state_leverage_probs(st, lam, mix=0.0).numpy()
        np.testing.assert_allclose(est.sum(), 1.0, atol=1e-5)
        assert (est >= 0).all()
        np.testing.assert_allclose(
            est, np.asarray(SJ.state_leverage_probs(stj, lam, mix=0.0)),
            rtol=1e-3, atol=1e-6)
        tvs.append(0.5 * np.abs(est - exact).sum())
    assert tvs[0] > tvs[1] > tvs[2], tvs
    assert tvs[2] < 0.05, tvs
    scores = ST.sketch_leverage_scores(st.C, st.W, lam).numpy()
    np.testing.assert_allclose(
        scores, np.asarray(SJ.sketch_leverage_scores(stj.C, stj.W, lam)),
        rtol=1e-3, atol=1e-6)


def test_leverage_oracles_match_reference_f64():
    n, lam, delta = 96, 1e-2, 1e-3
    with jax.enable_x64(True):
        X = jax.random.normal(jax.random.PRNGKey(4), (n, 2), jnp.float64)
        K = gaussian_kernel(X, X, 0.7)
        probs = jnp.linspace(1.0, 2.0, n)
        probs = probs / probs.sum()
        ref = dict(scores=LJ.leverage_scores(K, lam),
                   dstat=LJ.statistical_dimension(K, lam),
                   probs=LJ.leverage_probs(K, lam),
                   inc=LJ.incoherence(K, delta, probs),
                   dd=LJ.d_delta(LJ.spectrum(K), delta),
                   eigvals=LJ.spectrum(K).eigvals)
        Kt, pt = _t(K), _t(probs)
    spec = LT.spectrum(Kt)
    np.testing.assert_allclose(spec.eigvals.numpy(), np.asarray(ref["eigvals"]),
                               rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(LT.leverage_scores(Kt, lam, spec).numpy(),
                               np.asarray(ref["scores"]), rtol=1e-8)
    np.testing.assert_allclose(float(LT.statistical_dimension(Kt, lam)),
                               float(ref["dstat"]), rtol=1e-10)
    np.testing.assert_allclose(LT.leverage_probs(Kt, lam).numpy(),
                               np.asarray(ref["probs"]), rtol=1e-8)
    np.testing.assert_allclose(float(LT.incoherence(Kt, delta, pt)), float(ref["inc"]),
                               rtol=1e-6)
    assert LT.d_delta(spec, delta) == ref["dd"]
    approx = LT.approx_leverage_probs(torch.Generator().manual_seed(0), Kt, lam, 24)
    assert approx.shape == (n,) and float(approx.min()) > 0
    np.testing.assert_allclose(float(approx.sum()), 1.0, rtol=1e-12)
