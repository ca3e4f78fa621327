"""Port parity: repro_torch.core.sketch against repro.core.sketch.  The JAX
draw is carried across with ``interop.sketch_from_numpy``; the port's own
draws (a torch.Generator, not threefry) are checked for their law's
invariants and for reproducibility."""
import dataclasses

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



@pytest.mark.parametrize("nonuniform", [False, True])
@pytest.mark.parametrize("n,d,m", SHAPES)
def test_with_coef_after_truncation(n, d, m, nonuniform):
    """``truncated(mm).with_coef().coef_`` of a grown JAX draw carried across
    is the reference's for every mm, at its tolerance (rtol 1e-5, atol 1e-6,
    tests/test_sketch_properties.py:92-112): from the reference's cached
    coefficients (truncated's rescale) and from none (with_coef computes
    them); a sketch that holds them comes back as itself."""
    grown = SJ.append_subsample(_jax_draw(n, d, m, nonuniform=nonuniform),
                                jax.random.fold_in(KEY, n + 8))
    cached = interop.sketch_from_numpy(np.asarray(grown.indices), np.asarray(grown.signs),
                                       np.asarray(grown.probs), grown.n,
                                       np.asarray(grown.coef_), device="cpu")
    bare = dataclasses.replace(cached, coef_=None)
    assert bare.with_coef().coef_ is not None and cached.with_coef() is cached
    for mm in range(1, grown.m + 1):
        want = np.asarray(grown.truncated(mm).with_coef().coef_)
        for skt in (cached, bare):
            tt = skt.truncated(mm).with_coef()
            assert tt.coef_ is not None and tt.with_coef() is tt
            np.testing.assert_allclose(tt.coef_.numpy(), want, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(tt.coef_.numpy(), ST._compute_coef(
                tt.indices, tt.signs, tt.probs).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_with_coef_keeps_dtypes(dtype):
    """The port's twin of the reference's ``_check_dtype_preserved``: signs,
    probs and coef keep the constructor's dtype through append_subsample,
    truncated and with_coef, indices stay int32, and each dtype is the
    reference's for the same constructor chain."""
    n, d, m = 12, 6, 3
    tdt = getattr(torch, dtype)
    skj = SJ.make_accum_sketch(KEY, n, d, m, dtype=jnp.dtype(dtype))
    trj = SJ.append_subsample(skj, jax.random.fold_in(KEY, 3)).truncated(m)
    assert str(trj.with_coef().coef.dtype) == dtype
    for sk in (ST.make_accum_sketch(torch.Generator().manual_seed(1), n, d, m, dtype=tdt,
                                    device="cpu"),
               ST.make_accum_sketch_jit(torch.Generator().manual_seed(1), n, d, m,
                                        dtype=tdt, device="cpu")):
        for arr in (sk.signs, sk.probs, sk.coef, sk.coef_):
            assert arr.dtype == tdt, (arr.dtype, tdt)
        assert sk.indices.dtype == torch.int32
        grown = ST.append_subsample(sk, torch.Generator().manual_seed(3))
        tr = grown.truncated(sk.m)
        for derived in (grown, tr, tr.with_coef(),
                        dataclasses.replace(tr, coef_=None).with_coef()):
            for arr in (derived.signs, derived.probs, derived.coef, derived.coef_):
                assert arr.dtype == tdt, (arr.dtype, tdt)
            assert derived.indices.dtype == torch.int32

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


def test_sparse_rp_density_and_values():
    """Density 1/√n at the default s = √n (the reference's bound,
    tests/test_sketch.py:152), values in {0, ±√(s/d)}, and the reference's
    own draw under the same law."""
    g = torch.Generator().manual_seed(0)
    S = ST.make_sparse_rp(g, 400, 10, device="cpu")
    assert S.shape == (400, 10) and S.dtype == torch.float32
    density = (S != 0).float().mean().item()
    assert abs(density - 1 / np.sqrt(400)) < 0.03
    Sj = np.asarray(SJ.make_sparse_rp(KEY, 400, 10))
    assert abs(float((Sj != 0).mean()) - 1 / np.sqrt(400)) < 0.03

    def values_in(x, scale, rtol):
        x = np.abs(np.asarray(x, np.float64))
        return bool(np.all((x == 0) | np.isclose(x, scale, rtol=rtol, atol=0)))

    assert values_in(S, np.sqrt(np.sqrt(400) / 10), 1e-7)
    assert values_in(Sj, np.sqrt(np.sqrt(400) / 10), 1e-7)
    S4 = ST.make_sparse_rp(torch.Generator().manual_seed(1), 64, 8, s=4.0,
                           dtype=torch.float64, device="cpu")
    assert S4.dtype == torch.float64 and values_in(S4, np.sqrt(0.5), 1e-15)
    torch.testing.assert_close(S, ST.make_sparse_rp(torch.Generator().manual_seed(0), 400,
                                                    10, device="cpu"), rtol=0, atol=0)


def test_accum_sketch_jit_contract():
    """dtype reaches signs, probs and coef (tests/test_progressive.py:217),
    probs are normalized as the eager constructor's, the draw equals
    make_accum_sketch's for the same generator, and scheme="leverage"
    without probs raises (tests/test_schemes.py:177)."""
    def gen():
        return torch.Generator().manual_seed(5)

    sk16 = ST.make_accum_sketch_jit(gen(), 64, 8, 2, dtype=torch.bfloat16, device="cpu")
    assert sk16.signs.dtype == sk16.probs.dtype == sk16.coef.dtype == torch.bfloat16
    sk32 = ST.make_accum_sketch_jit(gen(), 64, 8, 2, device="cpu")
    assert sk32.signs.dtype == torch.float32
    eager = ST.make_accum_sketch(gen(), 64, 8, 2, device="cpu")
    assert torch.equal(sk32.indices, eager.indices) and torch.equal(sk32.coef, eager.coef)
    w = torch.linspace(1.0, 3.0, 64)
    skw = ST.make_accum_sketch_jit(gen(), 64, 8, 3, probs=w, signed=False, device="cpu")
    torch.testing.assert_close(skw.probs, w / w.sum())
    assert torch.equal(skw.signs, torch.ones_like(skw.signs))
    eager_w = ST.make_accum_sketch(gen(), 64, 8, 3, probs=w, signed=False, device="cpu")
    assert torch.equal(skw.indices, eager_w.indices)
    with pytest.raises(ValueError, match="leverage"):
        ST.make_accum_sketch_jit(gen(), 32, 4, 2, scheme="leverage", device="cpu")
    with pytest.raises(ValueError, match="leverage"):
        SJ.make_accum_sketch_jit(KEY, 32, 4, 2, scheme="leverage")
