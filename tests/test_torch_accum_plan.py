"""The host side of two CUDA kernels of ``accum_apply.cu``, on the CPU:
``matfree_apply``'s folded constants and its restated formula (each
evaluation an FMA chain and one ex2, ``kernel.matfree_fold`` and
``ref.folded_cols_ref``), and the load plan of the sorted column gather
(``kernel.gather_plan``, the kernel's bitonic network step for step).  The
kernels themselves are held against their plain versions on the card
(test_torch_cuda_kernels.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.kernels_math import _sqdist, get_kernel  # noqa: E402
from repro_torch.kernels.accum_apply import kernel as KT  # noqa: E402
from repro_torch.kernels.accum_apply import ref as RT  # noqa: E402

# the five kernel kinds at two bandwidths each
KINDS = [("gaussian", 0.5, 1.5), ("gaussian", 3.0, 1.5), ("laplacian", 0.5, 1.5),
         ("laplacian", 2.0, 1.5), ("matern", 0.5, 0.5), ("matern", 1.7, 0.5),
         ("matern", 0.8, 1.5), ("matern", 0.35, 1.5), ("matern", 0.8, 2.5),
         ("matern", 2.5, 2.5)]
# the self-pair cusp of the expanded distance (ROADMAP queue 3): Laplacian
# and Matérn ν = 0.5 are held to the float64 plain version at 5e-3, as on
# the card; the rest at 1e-5
CUSP = {("laplacian", 1.5), ("matern", 0.5)}


def _close(out, plain, tol):
    """allclose with atol = tol·max|plain|, as chip_smoke.py holds the kernel."""
    out, plain = out.double(), plain.double()
    torch.testing.assert_close(out, plain, rtol=tol, atol=tol * plain.abs().max().item())


@pytest.mark.parametrize("kernel,bw,nu", KINDS)
def test_folded_constants_reproduce_the_closed_forms_in_f64(kernel, bw, nu):
    """k from q = scale²·d2 and the fold's constants, applied in float64 on
    the reference's own squared distances (self pairs included), is
    core/kernels_math.py's closed form within 1e-12."""
    rng = np.random.default_rng(len(kernel) + int(10 * bw))
    A = torch.from_numpy(rng.standard_normal((80, 3)))
    B = torch.cat([A[:20], torch.from_numpy(3 * rng.standard_normal((40, 3)))])
    fold = KT.matfree_fold(kernel, bw, nu)
    assert fold.gauss == (kernel == "gaussian")
    got = RT.folded_value(fold.scale ** 2 * _sqdist(A, B), fold)
    want = get_kernel(kernel, bw, nu)(A, B)
    assert (got - want).abs().max().item() <= 1e-12


def test_unsupported_kernels_raise():
    with pytest.raises(ValueError, match="unsupported kernel"):
        KT.matfree_fold("matern", 1.0, 3.5)
    with pytest.raises(ValueError, match="unsupported kernel"):
        KT.matfree_fold("cauchy", 1.0)


@pytest.mark.parametrize("kernel,bw,nu", KINDS[::2])
@pytest.mark.parametrize("n,p,d,m", [(400, 3, 64, 4), (300, 1, 16, 16), (200, 7, 24, 3)])
def test_float32_restated_formula_holds_the_plain_version(n, p, d, m, kernel, bw, nu):
    """The kernel's float32 arithmetic (both points scaled, landmarks stored
    as (−2·l, ‖l‖²), the distance as a chain from the first product, 2^−q),
    on uniform rows and landmarks drawn from them (so every landmark meets
    itself), holds the float64 plain version within the card's tolerances:
    1e-5, and 5e-3 at the self-pair cusp."""
    rng = np.random.default_rng(n + p + d)
    X = torch.from_numpy(rng.random((n, p)))
    L = X[torch.from_numpy(rng.integers(0, n, m * d))]
    coef = torch.from_numpy(rng.standard_normal((m, d)) * np.sqrt(n / (d * m)))
    fold = KT.matfree_fold(kernel, bw, nu)
    out = RT.folded_cols_ref(X.float(), L.float(), coef.float(), fold)
    assert out.dtype == torch.float32 and out.shape == (n, d)
    plain = RT.landmark_cols_ref(X, L, coef, get_kernel(kernel, bw, nu))
    _close(out, plain, 5e-3 if (kernel, nu) in CUSP else 1e-5)


def test_matfree_shared_memory_records():
    """One float4 record a landmark for p ≤ 3, two for p ≤ 7, then the
    transposed layout; each with its coefficient (csrc matfree_quads)."""
    assert [KT.matfree_floats(p) for p in (1, 3, 4, 7, 8, 40)] == [5, 5, 9, 9, 10, 42]


def test_matfree_default_rows_keep_a_full_grid():
    """512 rows a block at the operator's n = 2²¹, halved while the grid
    would hold fewer than 1024 blocks, never below the static table's 64."""
    assert [KT.matfree_rows(n) for n in (2**21, 2**19, 2**19 - 1, 300_000, 65536, 1000)] \
        == [512, 512, 256, 256, 64, 64]


def _idx(m, d, N, seed, bad=()):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, N, (m, d)).astype(np.int32))
    for (i, j), v in bad:
        idx[i, j] = v
    return idx


GATHERS = [(1, 64, 32768, ()), (16, 64, 32768, ()), (4, 64, 8192, ()), (3, 7, 50, ()),
           (16, 64, 300, (((0, 5), 300), ((15, 63), -1), ((7, 0), 2**31 - 1))),
           (2, 9, 40, (((1, 8), 41),))]


@pytest.mark.parametrize("m,d,N,bad", GATHERS)
def test_gather_plan_covers_every_slot_once(m, d, N, bad):
    """The plan loads each (i, j) slot exactly once, in ascending column
    order (then slot order); an index outside [0, N) sorts last and its
    slot, loaded by nothing, gives NaN."""
    idx = _idx(m, d, N, m * d, bad)
    cols, slots = KT.gather_plan(idx)
    assert torch.equal(torch.sort(slots).values, torch.arange(m * d))
    keys = cols * (m * d) + slots
    assert bool((keys[1:] > keys[:-1]).all())
    flat = idx.reshape(-1).long()
    assert torch.equal(cols, flat[slots] & 0xFFFFFFFF)
    valid = cols < N
    assert int((~valid).sum()) == len(bad)
    assert bool(valid[: int(valid.sum())].all())   # the invalid ones last
    # a tile assembled by the plan, as the kernel fills its shared memory
    rng = np.random.default_rng(1)
    K = torch.from_numpy(rng.standard_normal((5, N)).astype(np.float32))
    tile = torch.full((5, m * d), float("nan"))
    tile[:, slots[valid]] = K[:, cols[valid]]
    ok = (flat >= 0) & (flat < N)
    want = torch.full((5, m * d), float("nan"))
    want[:, ok] = K[:, flat[ok]]
    assert torch.equal(tile.isnan(), ~ok.expand(5, -1))
    assert torch.equal(tile[:, ok], want[:, ok])


@pytest.mark.parametrize("m,d", [(16, 64), (3, 7)])
def test_gather_plan_is_a_function_of_idx_alone(m, d):
    """The plan takes nothing but idx: the same indices in any (m, d) shape
    or integer type give the same plan, and it is the stable sort of the
    flattened indices read as unsigned 32-bit."""
    idx = _idx(m, d, 1000, 7, (((0, 0), -3),))
    cols, slots = KT.gather_plan(idx)
    for other in (idx.reshape(1, -1), idx.reshape(-1, 1), idx.long(), idx.clone()):
        c2, s2 = KT.gather_plan(other)
        assert torch.equal(c2, cols) and torch.equal(s2, slots)
    flat = idx.reshape(-1).long() & 0xFFFFFFFF
    order = torch.sort(flat, stable=True).indices
    assert torch.equal(slots, order) and torch.equal(cols, flat[order])
