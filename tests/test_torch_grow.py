"""Port parity for the engine's kernels and batched growth: the plain
versions of ``accum_apply``, ``accum_step_slab`` and ``accum_grow_slabs``
(what the port's wrappers take for CPU tensors) against the reference's
Pallas kernels in interpret mode, and batched ≡ sequential growth on the
reference's draw, with the reference tests' sweeps and tolerances
(tests/test_grow_batched.py, tests/test_kernels.py, tests/test_progressive.py).
The CUDA kernels themselves are held against the plain versions in
test_torch_cuda_kernels.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import apply as AJ  # noqa: E402
from repro.core.kernel_op import KernelOperator as OpJ  # noqa: E402
from repro.core.sketch import make_accum_sketch  # noqa: E402
from repro.kernels.accum_apply import ops as OJ  # noqa: E402
from repro.kernels.accum_apply import ref as RJ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import apply as AT  # noqa: E402
from repro_torch.core.kernel_op import KernelOperator as OpT  # noqa: E402
from repro_torch.kernels.accum_apply import ops as OT  # noqa: E402
from repro_torch.kernels.accum_apply import ref as RT  # noqa: E402

KEY = jax.random.PRNGKey(0)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a32: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor in ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a32).astype(jd), torch.from_numpy(np.array(a32)).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _state(stj):
    """The port's empty engine state for the reference's accum_init draw."""
    return interop.state_from_numpy(np.asarray(stj.indices), np.asarray(stj.signs),
                                    np.asarray(stj.probs), np.asarray(stj.pdraw),
                                    stj.n, device="cpu")


def _problem(n=300, bandwidth=0.6):
    X = np.random.default_rng(n).uniform(size=(n, 3)).astype(np.float32)
    return (OpJ(jnp.asarray(X), "gaussian", bandwidth),
            OpT(torch.from_numpy(X), "gaussian", bandwidth))


# --------------------------------------------------------------------------- #
# the kernels' plain versions against the Pallas kernels
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,d,B", [(256, 16, 4), (300, 8, 8), (128, 64, 1),
                                   (173, 9, 3)])
def test_grow_kernel_plain_matches_pallas(n, d, B, dtype):
    rng = np.random.default_rng(n + d)
    Kj, Kt = _pair(rng.normal(size=(n, n)).astype(np.float32), dtype)
    idx = rng.integers(0, n, (B, d)).astype(np.int32)
    coef = rng.normal(size=(B, d)).astype(np.float32)
    C = rng.normal(size=(n, d)).astype(np.float32)
    a = 0.77
    ref = OJ.accum_grow_kernel(Kj, jnp.asarray(idx), jnp.asarray(coef),
                               jnp.asarray(C), jnp.float32(a))
    Ct = torch.from_numpy(C)
    got = OT.accum_grow_kernel(Kt, torch.from_numpy(idx), torch.from_numpy(coef),
                               Ct, a)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for x, y, atol in zip(got, ref, (tol, max(tol, 1e-3 * float(jnp.abs(ref[1]).max())),
                                     tol)):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(_np(x), _np(y), rtol=tol, atol=atol)
    # written over its own C, TᵀC still comes from the old C
    C2 = Ct.clone()
    inplace = OT.accum_grow_kernel(Kt, torch.from_numpy(idx),
                                   torch.from_numpy(coef), C2, a, out=C2)
    assert inplace[0] is C2
    for x, y in zip(inplace, got):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("R,N", [(256, 256), (64, OT.MAX_COLS + 777)])
def test_step_kernel_routes_match_pallas(R, N, dtype):
    """The single-slab step: N ≤ MAX_COLS is one accum_step_slab; the thin
    wide K takes the accum_apply route with G in K's dtype, in both
    packages."""
    rng = np.random.default_rng(R + N)
    d = 16
    Kj, Kt = _pair(rng.normal(size=(R, N)).astype(np.float32), dtype)
    idx = rng.integers(0, min(R, N), d).astype(np.int32)
    coef = rng.normal(size=d).astype(np.float32)
    C = rng.normal(size=(R, d)).astype(np.float32)
    a = 0.6
    ref = OJ.sketch_step_kernel(Kj, jnp.asarray(idx), jnp.asarray(coef),
                                jnp.asarray(C), jnp.float32(a))
    got = OT.sketch_step_kernel(Kt, torch.from_numpy(idx), torch.from_numpy(coef),
                                torch.from_numpy(C), a)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)
    if N <= OT.MAX_COLS:
        plain = RT.accum_step_ref(Kt, torch.from_numpy(idx[None]),
                                  torch.from_numpy(coef[None]), torch.from_numpy(C), a)
        assert torch.equal(plain, got)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("R,N,d,m", [(128, 256, 8, 1), (256, 512, 32, 4),
                                     (128, 1024, 16, 8), (256, 256, 64, 2)])
def test_sketch_right_kernel_matches_pallas(R, N, d, m, dtype):
    rng = np.random.default_rng(R + N + d)
    Kj, Kt = _pair(rng.normal(size=(R, N)).astype(np.float32), dtype)
    skj = make_accum_sketch(jax.random.fold_in(KEY, d * m), N, d, m)
    skt = interop.sketch_from_numpy(np.asarray(skj.indices), np.asarray(skj.signs),
                                    np.asarray(skj.probs), N, device="cpu")
    ref = OJ.sketch_right_kernel(Kj, skj, bm=128, bd=min(8, d))
    got = OT.sketch_right_kernel(Kt, skt)
    assert got.dtype == Kt.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)
    oracle = RJ.accum_apply_ref(Kj, skj.indices, skj.coef.astype(jnp.float32))
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# batched ≡ sequential on the reference's draw
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("B", [1, 3, 6])
@pytest.mark.parametrize("path,use_kernel", [
    ("dense", False), ("dense", True), ("operator", False), ("operator", True),
])
def test_batched_equals_sequential(path, use_kernel, B):
    n, d, m_max = 300, 16, 8
    opj, opt = _problem(n)
    Kj, Kt = (opj.dense(), opt.dense()) if path == "dense" else (opj, opt)
    stj = AJ.accum_init(KEY, n, d, m_max)
    seq = AT.accum_grow(Kt, _state(stj), B, use_kernel=False)
    bat = AT.accum_grow_batched(Kt, _state(stj), B, use_kernel=use_kernel)
    assert torch.equal(bat.indices, seq.indices)
    assert bat.m == seq.m == B
    assert _rel(bat.C, seq.C) < 1e-5
    assert _rel(bat.W, seq.W) < 1e-5
    ref = AJ.accum_grow_batched(Kj, stj, B, use_kernel=False, donate=False)
    assert _rel(bat.C, ref.C) < 1e-5
    assert _rel(bat.W, ref.W) < 1e-5


def test_batched_from_nonzero_start_matches_sequential():
    """Grow 3 slabs one by one, then a batch of 4 ≡ 7 sequential steps."""
    n, d = 300, 16
    _, opt = _problem(n)
    K = opt.dense()
    stj = AJ.accum_init(KEY, n, d, 8)
    seq7 = AT.accum_grow(K, _state(stj), 7, use_kernel=False)
    st3 = AT.accum_grow(K, _state(stj), 3, use_kernel=True)
    st7 = st3.grow_batched(K, 4, use_kernel=True)
    assert st7.m == 7
    assert _rel(st7.C, seq7.C) < 1e-5
    assert _rel(st7.W, seq7.W) < 1e-5


def test_batched_overrun_raises():
    n, d = 100, 8
    _, opt = _problem(n)
    K = opt.dense()
    st = AT.accum_grow(K, AT.accum_init(torch.Generator().manual_seed(0), n, d, 4,
                                        device="cpu"), 3, use_kernel=False)
    with pytest.raises(ValueError, match="overruns"):
        AT.accum_grow_batched(K, st, 2, use_kernel=False)
    with pytest.raises(ValueError, match="batch size"):
        AT.accum_grow_batched(K, st, 0, use_kernel=False)
    with pytest.raises(ValueError, match="already accumulated"):
        AT.accum_grow(opt, st, 2, use_kernel=False)


def test_doubling_schedule_matches_reference():
    for m_start, m_max in [(0, 1), (0, 6), (0, 32), (3, 8), (0, 100), (5, 5),
                           (0, 1000)]:
        assert AT.doubling_schedule(m_start, m_max) == \
            AJ.doubling_schedule(m_start, m_max)
    assert AT.doubling_schedule(0, 32) == [1, 2, 4, 8, 16, 1]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_grow_sketch_both_fixed_size_is_one_pass(use_kernel):
    """tol=None takes one batch of m_max slabs: one pass, and the one-shot
    sketch_both at m_max."""
    n, d, m_max = 300, 16, 8
    opj, opt = _problem(n)
    Kj, Kt = opj.dense(), opt.dense()
    stj = AJ.accum_init(KEY, n, d, m_max)
    st = _state(stj)
    sk, C, W, info = AT.grow_sketch_both(0, Kt, d, m_max=m_max, state=st,
                                         use_kernel=use_kernel)
    assert info["m"] == m_max and info["passes"] == 1
    assert torch.count_nonzero(st.C) == 0      # a caller's state is not grown in place
    C_ref, W_ref = AT.sketch_both(Kt, sk, use_kernel=False)
    assert _rel(C, C_ref) < 1e-5 and _rel(W, W_ref) < 1e-5
    _, Cj, Wj, infoj = AJ.grow_sketch_both(KEY, Kj, d, m_max=m_max,
                                           use_kernel=False)
    assert int(infoj["passes"]) == 1
    assert _rel(C, Cj) < 1e-5 and _rel(W, Wj) < 1e-5
    own = AT.grow_sketch_both(3, Kt, d, m_max=m_max, use_kernel=use_kernel)
    C_own, W_own = AT.sketch_both(Kt, own[0], use_kernel=False)
    assert _rel(own[1], C_own) < 1e-5 and _rel(own[2], W_own) < 1e-5
