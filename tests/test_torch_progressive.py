"""Port parity for the progressive accumulation engine and its entry points: the
reference's ``accum_init`` draw, holdout rows and Rademacher probes are
carried across (``interop.state_from_numpy``, ``hold=``, ``probes=``), and
the port must take the same steps — the same chosen m and passes, (C, W)
within the reference's 1e-5 relative (tests/test_progressive.py,
tests/test_grow_batched.py).  θ is held through the relative residual of
the reference's d×d Woodbury system, since the reference's own float32
spread at small m is 7.7e-4 (ROADMAP queue 3)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import apply as AJ  # noqa: E402
from repro.core import krr as KJ  # noqa: E402
from repro.core.kernel_op import KernelOperator as OpJ  # noqa: E402
from repro.core.sketch import append_subsample as append_j  # noqa: E402
from repro.core.sketch import make_accum_sketch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch._util import HOLDOUT_STREAM  # noqa: E402
from repro_torch.core import apply as AT  # noqa: E402
from repro_torch.core import krr as KT  # noqa: E402
from repro_torch.core import sketch as ST  # noqa: E402
from repro_torch.core.kernel_op import KernelOperator as OpT  # noqa: E402

KEY = jax.random.PRNGKey(0)
LAM = 1e-3


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _state(stj):
    return interop.state_from_numpy(np.asarray(stj.indices), np.asarray(stj.signs),
                                    np.asarray(stj.probs), np.asarray(stj.pdraw),
                                    stj.n, device="cpu", scheme=stj.scheme)


def _data(n, seed=0, bandwidth=0.5):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 3)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - X[:, 2]
         + 0.3 * rng.normal(size=n)).astype(np.float32)
    opj = OpJ(jnp.asarray(X), "gaussian", bandwidth)
    return X, y, opj, OpT(torch.from_numpy(X), "gaussian", bandwidth)


def _estimators(n, K_j, K_t, kind):
    """The reference's default estimator and the port's on the same rows or
    probes (the reference draws them from its key's tagged stream)."""
    key = jax.random.fold_in(KEY, HOLDOUT_STREAM)
    if kind == "holdout":
        hold = np.array(jax.random.choice(key, n, shape=(min(64, n),),
                                            replace=False))
        return (AJ.make_holdout_estimator(key, K_j),
                AT.make_holdout_estimator(None, K_t, hold=hold))
    Z = np.array(jax.random.rademacher(key, (n, 8), dtype=jnp.float32))
    return (AJ.make_hutchinson_estimator(key, K_j),
            AT.make_hutchinson_estimator(None, K_t, probes=Z))


def _woodbury_residual(C, W, y, theta, n):
    C, W, y, theta = (np.asarray(_np(a)) for a in (C, W, y, theta))
    M = C.T @ C + n * LAM * W
    rhs = C.T @ y
    return np.linalg.norm(M @ theta - rhs) / np.linalg.norm(rhs)


# --------------------------------------------------------------------------- #
# incremental ≡ one-shot
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("m", [1, 3, 6])
def test_incremental_matches_one_shot(m, use_kernel):
    """Growing to m slab by slab equals the one-shot sketch_both at m on the
    reference's draw, and the reference's own trajectory."""
    n, d = 300, 16
    _, _, opj, opt = _data(n, bandwidth=0.6)
    Kj, Kt = opj.dense(), opt.dense()
    skj = make_accum_sketch(KEY, n, d, m)
    stj = AJ.accum_init(KEY, n, d, m)
    st = AT.accum_grow(Kt, _state(stj), m, use_kernel=use_kernel)
    assert st.m == m
    np.testing.assert_array_equal(st.indices.numpy(), np.asarray(skj.indices))
    skt = interop.sketch_from_numpy(np.asarray(skj.indices), np.asarray(skj.signs),
                                    np.asarray(skj.probs), n, device="cpu")
    C1, W1 = AT.sketch_both(Kt, skt, use_kernel=False)
    assert _rel(st.C, C1) < 1e-5 and _rel(st.W, W1) < 1e-5
    ref = AJ.accum_grow(Kj, stj, m, use_kernel=False, donate=False)
    assert _rel(st.C, ref.C) < 1e-5 and _rel(st.W, ref.W) < 1e-5
    np.testing.assert_allclose(st.sketch().coef.numpy(), np.asarray(skj.coef),
                               rtol=1e-6)


def test_operator_unit_steps_match_reference():
    n, d, m = 250, 12, 4
    _, _, opj, opt = _data(n, seed=1)
    stj = AJ.accum_init(KEY, n, d, m)
    ref = AJ.accum_grow(opj, stj, m, use_kernel=False, donate=False)
    for uk in (False, True):
        st = AT.accum_grow(opt, _state(stj), m, use_kernel=uk)
        assert _rel(st.C, ref.C) < 1e-5 and _rel(st.W, ref.W) < 1e-5


def test_masked_sketch_applies_like_sketch():
    n, d = 200, 8
    _, _, _, opt = _data(n)
    K = opt.dense()
    st = AT.accum_grow(K, AT.accum_init(torch.Generator().manual_seed(1), n, d, 6,
                                        device="cpu"), 4, use_kernel=False)
    C_a, W_a = AT.sketch_both(K, st.sketch(), use_kernel=False)
    C_b, W_b = AT.sketch_both(K, st.masked_sketch(), use_kernel=False)
    assert st.masked_sketch().m == 6
    assert _rel(C_b, C_a) < 1e-6 and _rel(W_b, W_a) < 1e-6
    assert _rel(st.C, C_a) < 1e-5 and _rel(st.W, W_a) < 1e-5


# --------------------------------------------------------------------------- #
# the entry points: same chosen m and passes on the same draw
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["holdout", "hutchinson"])
@pytest.mark.parametrize("schedule", ["doubling", "unit"])
@pytest.mark.parametrize("path", ["dense", "operator"])
def test_grow_sketch_both_matches_reference(path, schedule, kind):
    n, d, m_max = 300, 12, 16
    _, _, opj, opt = _data(n, seed=2, bandwidth=0.4)
    Kj, Kt = (opj.dense(), opt.dense()) if path == "dense" else (opj, opt)
    est_j, est_t = _estimators(n, Kj, Kt, kind)
    # between the estimates at the checked m, so both stop inside the budget
    tol = 0.13 if kind == "holdout" else 0.2
    stj = AJ.accum_init(KEY, n, d, m_max)
    skj, Cj, Wj, ij = AJ.grow_sketch_both(KEY, Kj, d, m_max=m_max, tol=tol,
                                          estimator=est_j, use_kernel=False,
                                          schedule=schedule)
    for uk in (False, True):
        sk, C, W, info = AT.grow_sketch_both(0, Kt, d, m_max=m_max, tol=tol,
                                             estimator=est_t, use_kernel=uk,
                                             schedule=schedule,
                                             state=_state(stj))
        assert (info["m"], info["passes"]) == (int(ij["m"]), int(ij["passes"]))
        assert 1 < info["m"] < m_max          # the target bites and is met
        assert info["err"] <= tol
        np.testing.assert_allclose(info["err"], float(ij["err"]), rtol=1e-4)
        assert _rel(C, Cj) < 1e-5 and _rel(W, Wj) < 1e-5
        np.testing.assert_array_equal(sk.indices.numpy(), np.asarray(skj.indices))


@pytest.mark.parametrize("kind", ["holdout", "hutchinson"])
@pytest.mark.parametrize("schedule", ["doubling", "unit"])
def test_adaptive_krr_matches_reference(schedule, kind):
    n, d = 400, 16
    _, y, opj, opt = _data(n, seed=3, bandwidth=0.4)
    Kj, Kt = opj.dense(), opt.dense()
    est_j, est_t = _estimators(n, Kj, Kt, kind)
    tol = 0.08 if kind == "holdout" else 0.11
    stj = AJ.accum_init(KEY, n, d, 32)
    mj = KJ.krr_sketched_fit_adaptive(Kj, jnp.asarray(y), LAM, KEY, d, tol=tol,
                                      m_max=32, estimator=est_j,
                                      use_kernel=False, schedule=schedule)
    Cj, Wj = AJ.sketch_both(Kj, mj.sk, use_kernel=False)
    mt = KT.krr_sketched_fit_adaptive(Kt, torch.from_numpy(y), LAM, 0, d,
                                      tol=tol, m_max=32, estimator=est_t,
                                      use_kernel=True, schedule=schedule,
                                      state=_state(stj))
    for k in ("m", "passes"):
        assert mt.info[k] == int(mj.info[k])
    assert mt.info["m"] > 1 and not mt.info["solve_used_lstsq"]
    assert _woodbury_residual(Cj, Wj, y, mt.theta, n) <= 1e-4
    mp = KT.krr_sketched_fit_pcg_adaptive(Kt, torch.from_numpy(y), LAM, 0, d,
                                          tol=tol, m_max=32, estimator=est_t,
                                          schedule=schedule, state=_state(stj))
    mpj = KJ.krr_sketched_fit_pcg_adaptive(Kj, jnp.asarray(y), LAM, KEY, d,
                                           tol=tol, m_max=32, estimator=est_j,
                                           use_kernel=False, schedule=schedule)
    assert mp.info["m"] == int(mpj.info["m"])
    np.testing.assert_allclose(mp.fitted.numpy(), np.asarray(mpj.fitted),
                               rtol=1e-3, atol=1e-3 * np.abs(mpj.fitted).max())


def test_check_every_amortizes_the_unit_estimator():
    n, d = 300, 12
    _, _, opj, opt = _data(n, seed=2, bandwidth=0.4)
    Kj, Kt = opj.dense(), opt.dense()
    est_j, est_t = _estimators(n, Kj, Kt, "holdout")
    stj = AJ.accum_init(KEY, n, d, 16)
    ref = AJ.accum_grow_adaptive(Kj, stj, tol=0.13, estimator=est_j,
                                 check_every=3, use_kernel=False)
    st = AT.accum_grow_adaptive(Kt, _state(stj), tol=0.13, estimator=est_t,
                                check_every=3, use_kernel=False)
    assert st.m == int(ref.m) and st.m % 3 == 0
    assert _rel(st.C, ref.C) < 1e-5
    with pytest.raises(ValueError, match="schedule"):
        AT.accum_grow_adaptive(Kt, st, tol=0.1, estimator=est_t,
                               schedule="bogus")


def test_doubling_stops_both_ways():
    """Early on an easy kernel; budget exhausted, every phase run, on an
    unreachable target (tests/test_grow_batched.py)."""
    n = 300
    _, _, opj, opt = _data(n, seed=5, bandwidth=0.8)
    sk, C, W, info = AT.grow_sketch_both(0, opt.dense(), 24, m_max=16, tol=0.2,
                                         use_kernel=False)
    assert info["m"] < 16 and info["err"] <= 0.2
    assert info["passes"] <= len(AT.doubling_schedule(0, 16))
    X = torch.rand((200, 3), generator=torch.Generator().manual_seed(6))
    lap = OpT(X, "laplacian", 0.5).dense()
    sk, C, W, info = AT.grow_sketch_both(0, lap, 8, m_max=6, tol=1e-6,
                                         use_kernel=False)
    assert info["m"] == 6 and np.isfinite(info["err"]) and info["err"] > 1e-6
    assert info["passes"] == len(AT.doubling_schedule(0, 6)) == 3
    with pytest.raises(ValueError, match="empty state"):
        AT.grow_sketch_both(0, lap, 8, m_max=6, state=AT.accum_init(
            torch.Generator(), 200, 8, 5, device="cpu"))


def test_seeded_draws_are_reproducible_and_decorrelated():
    n, d = 300, 12
    _, _, _, opt = _data(n, seed=2, bandwidth=0.4)
    K = opt.dense()
    a = AT.grow_sketch_both(7, K, d, m_max=8, tol=0.05, use_kernel=False)
    b = AT.grow_sketch_both(7, K, d, m_max=8, tol=0.05, use_kernel=False)
    assert torch.equal(a[0].indices, b[0].indices) and torch.equal(a[1], b[1])
    assert a[3] == b[3]
    c = AT.grow_sketch_both(8, K, d, m_max=8, tol=0.05, use_kernel=False)
    assert not torch.equal(a[0].indices[:1], c[0].indices[:1])


# --------------------------------------------------------------------------- #
# append_subsample and the carried-across state
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("scheme", ["uniform", "poisson"])
def test_append_subsample(scheme):
    n, d, m = 120, 8, 3
    g = torch.Generator().manual_seed(0)
    sk = ST.make_accum_sketch(g, n, d, m, scheme=scheme, device="cpu")
    sk2 = ST.append_subsample(sk, g)
    assert sk2.m == m + 1 and sk2.scheme == scheme
    assert torch.equal(sk2.indices[:m], sk.indices)
    # the survivors' coefficients rescale by sqrt(m/(m+1))
    np.testing.assert_allclose(sk2.coef[:m].numpy(),
                               sk.coef.numpy() * np.sqrt(m / (m + 1)), rtol=1e-6)
    skj = make_accum_sketch(KEY, n, d, m, scheme=scheme)
    skj2 = append_j(skj, jax.random.fold_in(KEY, 1))
    assert skj2.coef.shape == tuple(sk2.coef.shape)


def test_state_from_numpy_round_trip():
    stj = AJ.accum_init(KEY, 90, 6, 5, scheme="poisson")
    st = _state(stj)
    assert (st.n, st.d, st.m_max, st.m, st.scheme) == (90, 6, 5, 0, "poisson")
    assert st.err == float("inf") and torch.count_nonzero(st.C) == 0
    np.testing.assert_array_equal(st.pdraw.numpy(), np.asarray(stj.pdraw))
    with pytest.raises(RuntimeError if not torch.cuda.is_available() else ValueError):
        interop.state_from_numpy(np.asarray(stj.indices), np.asarray(stj.signs),
                                 np.asarray(stj.probs), np.asarray(stj.pdraw), 90,
                                 device="cuda" if not torch.cuda.is_available()
                                 else "cuda:99")


def test_holdout_rows_are_a_uniform_subset():
    """The holdout rows come from Floyd's algorithm (O(h) host draws): k
    distinct rows, every row at k = n, and equal marginals."""
    from repro_torch.core.apply import _rows_without_replacement

    rows = _rows_without_replacement(torch.Generator().manual_seed(0), 2**21, 64)
    assert rows.numel() == 64 == len(set(rows.tolist()))
    assert 0 <= int(rows.min()) and int(rows.max()) < 2**21
    full = _rows_without_replacement(torch.Generator().manual_seed(1), 64, 64)
    assert sorted(full.tolist()) == list(range(64))
    counts = np.zeros(10)
    for s in range(4000):
        counts[_rows_without_replacement(torch.Generator().manual_seed(s), 10, 3)] += 1
    # each row is held out with probability 3/10: 1200 ± 4.5 sd of 29
    assert np.abs(counts - 1200).max() < 130, counts
