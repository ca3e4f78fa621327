"""Port parity: repro_torch.core.sketch against repro.core.sketch.  The JAX
draw is carried across with ``interop.sketch_from_numpy``; the port's own
draws (a torch.Generator, not threefry) are checked for their law's
invariants and for reproducibility."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sketch as SJ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import sketch as ST  # noqa: E402

KEY = jax.random.PRNGKey(0)
SHAPES = [(300, 12, 3), (97, 8, 1), (64, 16, 8)]


def _across(sk):
    return interop.sketch_from_numpy(np.asarray(sk.indices), np.asarray(sk.signs),
                                     np.asarray(sk.probs), sk.n, device="cpu")


def _jax_draw(n, d, m, *, nonuniform=False, signed=True):
    probs = None
    if nonuniform:
        probs = jnp.asarray(np.random.default_rng(n).uniform(0.1, 2.0, n),
                            jnp.float32)
    return SJ.make_accum_sketch(jax.random.fold_in(KEY, n + d + m), n, d, m,
                                probs=probs, signed=signed)


@pytest.mark.parametrize("nonuniform", [False, True])
@pytest.mark.parametrize("n,d,m", SHAPES)
def test_jax_draw_across(n, d, m, nonuniform):
    skj = _jax_draw(n, d, m, nonuniform=nonuniform)
    skt = _across(skj)
    assert (skt.m, skt.d, skt.n) == (m, d, n)
    np.testing.assert_allclose(skt.coef.numpy(), np.asarray(skj.coef),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(skt.dense().numpy(), np.asarray(skj.dense()),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(skt.nnz_per_column().numpy(),
                                  np.asarray(skj.nnz_per_column()))
    for k in range(1, m + 1):
        tj, tt = skj.truncated(k), skt.truncated(k)
        assert tt.m == k
        np.testing.assert_allclose(tt.coef.numpy(), np.asarray(tj.coef),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(tt.dense().numpy(), np.asarray(tj.dense()),
                                   rtol=1e-6, atol=1e-7)


def test_nnz_counts_cancelling_collisions():
    """Two draws of one row with opposite signs cancel: a zero of S."""
    skt = interop.sketch_from_numpy(np.array([[3, 5], [3, 6]]),
                                    np.array([[1.0, 1.0], [-1.0, 1.0]], np.float32),
                                    np.full(10, 0.1, np.float32), 10, device="cpu")
    assert skt.nnz_per_column().tolist() == [0, 2]
    assert torch.count_nonzero(skt.dense()[:, 0]) == 0


def test_interop_refuses_out_of_range_indices():
    with pytest.raises(ValueError):
        interop.sketch_from_numpy(np.array([[0, 10]]), np.ones((1, 2)),
                                  np.full(10, 0.1), 10, device="cpu")


@pytest.mark.parametrize("n,d,m", SHAPES)
def test_own_draw_law_and_reproducibility(n, d, m):
    def draw(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return ST.make_accum_sketch(g, n, d, m, device="cpu", **kw)

    sk = draw(7)
    assert sk.indices.dtype == torch.int32 and sk.indices.shape == (m, d)
    assert int(sk.indices.min()) >= 0 and int(sk.indices.max()) < n
    assert set(sk.signs.unique().tolist()) <= {-1.0, 1.0}
    np.testing.assert_allclose(sk.coef.numpy(),
                               sk.signs.numpy() / np.sqrt(d * m / n), rtol=1e-6)
    again = draw(7)
    assert torch.equal(sk.indices, again.indices)
    assert torch.equal(sk.signs, again.signs)
    assert not torch.equal(sk.indices, draw(8).indices)
    # explicit probs: rows of zero probability are never drawn
    probs = np.zeros(n)
    probs[::3] = 1.0
    skp = draw(7, probs=probs)
    assert (skp.indices.numpy() % 3 == 0).all()
    np.testing.assert_allclose(skp.probs.sum().item(), 1.0, rtol=1e-6)


def test_nystrom_unsigned_and_gaussian():
    g = torch.Generator().manual_seed(0)
    sk = ST.make_nystrom_sketch(g, 500, 20, device="cpu")
    assert sk.m == 1 and bool((sk.signs == 1).all())
    S = ST.make_gaussian_sketch(g, 4000, 50, device="cpu")
    assert S.shape == (4000, 50)
    assert abs(float(S.var()) * 50 - 1.0) < 0.05


def test_schemes():
    g = torch.Generator().manual_seed(0)
    skp = ST.make_accum_sketch(g, 50, 4, 2, scheme="poisson", device="cpu")
    assert skp.scheme == "poisson" and skp.indices.shape == (2, 4)
    # π/d is stored as the per-row probability: uniform π = d/n
    np.testing.assert_allclose(skp.probs.numpy(), 1.0 / 50, rtol=1e-6)
    with pytest.raises(ValueError):
        ST.make_accum_sketch(g, 50, 4, 2, scheme="leverage", device="cpu")
    with pytest.raises(ValueError):
        ST.make_accum_sketch(g, 50, 4, 2, scheme="stratified", device="cpu")
    sk = ST.make_accum_sketch(g, 50, 4, 2, scheme="leverage",
                              probs=np.arange(1, 51), device="cpu")
    assert sk.scheme == "leverage"
    with pytest.raises(ValueError):
        sk.truncated(3)
