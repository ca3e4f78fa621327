"""Port parity for ``accum_apply_scalar`` (AA:529), the seed's scalar
per-column gather loop: the reference's Pallas kernel in interpret mode on
the CPU against the port's entry point on CPU tensors (its plain version,
``ref.accum_apply_ref``), on the same numpy-seeded K and JAX draw, at the
tolerances of tests/test_kernels.py:42 — and the shapes the reference's
assert rejects are rejected by the port with ``ValueError``.  The CUDA
kernel is held against the plain version in test_torch_cuda_kernels.py.

The reference kernel reads K with ``pl.load``, which jax 0.9 removed (its
replacement is ref indexing, ``ref[idx]``): the ``pallas_load`` fixture
supplies it for each test where it is missing, so the reference's own
kernel body runs in interpret mode; nothing in the JAX package changes
(ROADMAP queue 3)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jax.experimental import pallas as pl  # noqa: E402

from repro.core.sketch import make_accum_sketch  # noqa: E402
from repro.kernels.accum_apply.kernel import accum_apply_scalar as scalar_jax  # noqa: E402
from repro.kernels.accum_apply.ref import accum_apply_ref  # noqa: E402
from repro_torch.kernels.accum_apply import kernel as KT  # noqa: E402
from repro_torch.kernels.accum_apply import ops as OT  # noqa: E402

KEY = jax.random.PRNGKey(0)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True)
def pallas_load(monkeypatch):
    """``pl.load(ref, idx)`` as ``ref[idx]`` where this jax lacks it."""
    if not hasattr(pl, "load"):
        monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)


def _inputs(R, N, d, m, dtype):
    jd, td, _ = DTYPES[dtype]
    K = np.random.default_rng(R + N + d + m).normal(size=(R, N)).astype(np.float32)
    sk = make_accum_sketch(jax.random.fold_in(KEY, d * m), N, d, m)
    idx, coef = np.asarray(sk.indices), np.asarray(sk.coef.astype(jnp.float32))
    return ((jnp.asarray(K).astype(jd), sk.indices, jnp.asarray(coef)),
            (torch.from_numpy(K).to(td), torch.from_numpy(idx.copy()),
             torch.from_numpy(coef.copy())))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bm", [32, 256])
@pytest.mark.parametrize("R,N,d,m", [(64, 128, 16, 3), (256, 512, 32, 4)])
def test_scalar_kernel_parity(R, N, d, m, bm, dtype):
    (Kj, idxj, coefj), (Kt, idxt, coeft) = _inputs(R, N, d, m, dtype)
    tol = DTYPES[dtype][2]
    theirs = scalar_jax(Kj, idxj, coefj, bm=bm, bd=8, interpret=True)
    ours = OT.accum_apply_scalar(Kt, idxt, coeft, bm=bm, bd=8)
    assert ours.dtype == Kt.dtype and ours.shape == (R, d)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs.astype(jnp.float32)), rtol=tol, atol=tol)
    # and both against the reference's oracle
    oracle = np.asarray(accum_apply_ref(Kj, idxj, coefj).astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("R,d,bm,bd", [(100, 16, 32, 8), (96, 12, 32, 8),
                                       (300, 16, 256, 8), (64, 20, 64, 8)])
def test_scalar_rejects_what_the_reference_asserts(R, d, bm, bd):
    (Kj, idxj, coefj), (Kt, idxt, coeft) = _inputs(R, 64, d, 2, "float32")
    with pytest.raises(AssertionError):
        scalar_jax(Kj, idxj, coefj, bm=bm, bd=bd, interpret=True)
    with pytest.raises(ValueError, match="R % bm == 0 and d % bd == 0"):
        OT.accum_apply_scalar(Kt, idxt, coeft, bm=bm, bd=bd)
    with pytest.raises(ValueError, match="R % bm == 0 and d % bd == 0"):
        KT.scalar_blocks(R, d, bm, bd)


@pytest.mark.parametrize("R,d,bm,bd,want", [(64, 16, 256, 8, (64, 8)),
                                            (96, 4, 32, 8, (32, 4)),
                                            (256, 32, 256, 8, (256, 8))])
def test_scalar_clips_blocks_as_the_reference(R, d, bm, bd, want):
    """bm and bd are clipped to R and d before the divisibility check."""
    assert KT.scalar_blocks(R, d, bm, bd) == want
