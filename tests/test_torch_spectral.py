"""Port parity for sketched eigendecomposition and spectral clustering: the
Nyström lift, the degrees and the embedding against the reference on the
same (C, W) (eigenvectors up to sign), k-means on separated blobs, and the
pipeline on the planted blobs of examples/sketched_pca_kmeans.py at
n = 1200 on both routes (fixed m and ``tol``), where the port must agree
with the planted labels as the reference does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import apply as AJ  # noqa: E402
from repro.core import spectral as SJ  # noqa: E402
from repro.core.kernels_math import gaussian_kernel  # noqa: E402
from repro.core.sketch import make_accum_sketch  # noqa: E402
from repro_torch.core import spectral as STP  # noqa: E402

KEY = jax.random.PRNGKey(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(n=150, d=32, m=4, sep=2.5):
    """(C, W) of a planted 2-block affinity from the reference's sketch, as
    float32 numpy arrays (tests/test_spectral.py)."""
    mu = jnp.array([sep, 0.0])
    X = jnp.concatenate([jax.random.normal(KEY, (n, 2)) * 0.4 - mu,
                         jax.random.normal(jax.random.fold_in(KEY, 1), (n, 2)) * 0.4 + mu])
    K = gaussian_kernel(X, X, bandwidth=1.0)
    C, W = AJ.sketch_both(K, make_accum_sketch(KEY, 2 * n, d, m), use_kernel=False)
    return np.asarray(C, np.float32), np.asarray(W, np.float32)


def _pairwise_agreement(truth, lab):
    """Share of point pairs on which the two labelings agree about being in
    one cluster (label-permutation free)."""
    truth, lab = np.asarray(truth), np.asarray(lab)
    return float(((truth[:, None] == truth[None, :])
                  == (lab[:, None] == lab[None, :])).mean())


def _assert_same_up_to_sign(U, V, atol):
    signs = np.sign(np.sum(U * V, axis=0))
    np.testing.assert_allclose(U * signs[None, :], V, atol=atol)


@pytest.mark.parametrize("k", [2, 6])
def test_nystrom_eigh_matches_reference(k):
    C, W = _pair()
    ev_j, U_j = SJ.nystrom_eigh(jnp.asarray(C), jnp.asarray(W), k)
    ev_t, U_t = STP.nystrom_eigh(_t(C), _t(W), k)
    np.testing.assert_allclose(ev_t.numpy(), np.asarray(ev_j), rtol=1e-4)
    _assert_same_up_to_sign(U_t.numpy(), np.asarray(U_j), 1e-4)
    np.testing.assert_allclose(U_t.T @ U_t, np.eye(k), atol=1e-4)


def test_degrees_and_embedding_match_reference():
    C, W = _pair(n=100, d=16, m=2)
    np.testing.assert_allclose(STP.sketched_degrees(_t(C), _t(W)).numpy(),
                               np.asarray(SJ.sketched_degrees(jnp.asarray(C),
                                                              jnp.asarray(W))),
                               rtol=1e-4, atol=1e-4)
    for normalized in (True, False):
        ev_j, U_j = SJ.sketched_spectral_embedding(jnp.asarray(C), jnp.asarray(W), 2,
                                                   normalized=normalized)
        ev_t, U_t = STP.sketched_spectral_embedding(_t(C), _t(W), 2,
                                                    normalized=normalized)
        np.testing.assert_allclose(ev_t.numpy(), np.asarray(ev_j), rtol=1e-4)
        # the normalized top pair is nearly degenerate: compare the subspace
        U_t, U_j = U_t.numpy(), np.asarray(U_j)
        np.testing.assert_allclose(U_t @ U_t.T, U_j @ U_j.T, atol=1e-4)


def test_kmeans_recovers_separated_blobs():
    k, per = 3, 60
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(size=(per, 2)) * 0.3
                        + 5.0 * np.array([np.cos(2 * np.pi * j / k),
                                          np.sin(2 * np.pi * j / k)])
                        for j in range(k)]).astype(np.float32)
    truth = np.repeat(np.arange(k), per)
    labels, centers, inertia = STP.kmeans(torch.Generator().manual_seed(99),
                                          _t(X), k)
    assert _pairwise_agreement(truth, labels.numpy()) == 1.0
    assert centers.shape == (k, 2)
    assert float(inertia) < per * k * 0.3**2 * 2 * 2.0
    again = STP.kmeans(torch.Generator().manual_seed(99), _t(X), k)
    assert torch.equal(labels, again[0])


@pytest.fixture(scope="module")
def blobs():
    """The planted blobs of examples/sketched_pca_kmeans.py: four clusters
    at 4·e_j in p = 32, n = 1200 rows, gaussian affinity of bandwidth 4."""
    key = jax.random.PRNGKey(0)
    n, p, k = 4000, 32, 4
    Xc = jnp.concatenate([jax.random.normal(jax.random.fold_in(key, 7 + j), (n // k, p))
                          * 0.5 + 4.0 * jnp.eye(p)[j] for j in range(k)])
    Xs = Xc[jax.random.choice(jax.random.fold_in(key, 123), n, (1200,), replace=False)]
    return np.asarray(gaussian_kernel(Xs, Xs, bandwidth=4.0)), np.asarray(
        jnp.argmax(Xs, axis=1))


@pytest.mark.parametrize("route", ["fixed", "tol"])
def test_spectral_cluster_planted_blobs(blobs, route):
    K, truth = blobs
    kw = dict(m=8) if route == "fixed" else dict(tol=0.2, m_max=16)
    ref = SJ.spectral_cluster(jax.random.fold_in(KEY, 321), jnp.asarray(K), 4,
                              d=32, **kw)
    res = STP.spectral_cluster(0, _t(K), 4, d=32, **kw)
    assert res.labels.shape == (1200,) and res.embedding.shape == (1200, 4)
    assert bool(torch.isfinite(res.eigvals).all())
    assert _pairwise_agreement(truth, res.labels.numpy()) >= \
        _pairwise_agreement(truth, np.asarray(ref.labels)) - 1e-3
    if route == "tol":
        assert 1 <= res.info["m"] <= 16 and res.sketch.m == res.info["m"]
        assert res.info["err"] <= 0.2 or res.info["m"] == 16
    else:
        assert res.info["m"] == res.sketch.m == 8
    with pytest.raises(ValueError, match="either"):
        STP.spectral_cluster(0, _t(K), 4, d=32, m=4, tol=0.1)
