"""Port parity for the landmark-attention kernels' plain versions and entry
points against the reference's Pallas kernels (run in interpret mode on the
CPU, as tests/test_kernels.py runs them), on the padded shapes of
tests/test_kernels.py.  Inputs are made with numpy and given to both.

Tolerances: 1e-5 for the single kernels, the reference's own
(tests/test_kernels.py:235, :255) — both sides sum in float32, in other
orders; 1e-4 for the full accum_attention pipeline, the reference's own
(tests/test_kernels.py:217) — Newton–Schulz amplifies the sum-order noise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.sketched_attention import make_seq_sketch  # noqa: E402
from repro.kernels.landmark_attention import ops as OJ  # noqa: E402
from repro.kernels.landmark_attention.ref import (  # noqa: E402
    landmark_attention_ref as attn_ref_j,
    landmark_stats_ref as stats_ref_j,
)
from repro_torch import interop  # noqa: E402
from repro_torch.core.sketched_attention import accum_attention  # noqa: E402
from repro_torch.kernels.landmark_attention import ops as OT  # noqa: E402
from repro_torch.kernels.landmark_attention import ref as RT  # noqa: E402


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("S,L,Dv", [(100, 13, 24), (7, 3, 5), (256, 64, 64)])
def test_landmark_attend_matches_reference(S, L, Dv):
    """Plain version and the padded entry point (L padded to 8 with −1e30
    bias) against the reference's oracle and its interpret-mode kernel."""
    Dh = 16
    q, kt, M, bias = _inputs(S + L, (S, Dh), (L, Dh), (L, Dv), (L,))
    ref = np.asarray(attn_ref_j(*map(jnp.asarray, (q, kt, M, bias))))
    kern = np.asarray(OJ.landmark_attend(*map(jnp.asarray, (q, kt, M, bias)), bq=64,
                                         interpret=True))
    plain = RT.landmark_attention_ref(*_t(q, kt, M, bias)).numpy()
    ops = OT.landmark_attend(*_t(q, kt, M, bias)).numpy()
    assert ops.shape == (S, Dv)
    for got in (plain, ops):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)


def test_landmark_attend_batched_and_fully_masked_rows():
    """A batch axis gives the per-problem results; a problem whose every
    landmark has the −1e30 bias gets the reference's uniform weights over
    the padded landmark axis, finite."""
    q, kt, M = _inputs(3, (3, 9, 16), (3, 13, 16), (3, 13, 8))
    bias = np.zeros((3, 13), np.float32)
    bias[1] = -1e30
    got = OT.landmark_attend(*_t(q, kt, M, bias)).numpy()
    for p in range(3):
        want = np.asarray(OJ.landmark_attend(*map(jnp.asarray, (q[p], kt[p], M[p], bias[p])),
                                             bq=64, interpret=True))
        np.testing.assert_allclose(got[p], want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("S,L,Dv", [(130, 10, 24), (512, 32, 16), (9, 5, 8)])
def test_landmark_stats_matches_reference(S, L, Dv):
    """W and BmV of the plain version and the entry point against the
    reference's oracle and its interpret-mode fused sweep."""
    Dh = 16
    qt, kt, k, v = _inputs(S * L, (L, Dh), (L, Dh), (S, Dh), (S, Dv))
    W_ref, B_ref = stats_ref_j(*map(jnp.asarray, (qt, kt, k, v)))
    W_k, B_k = OJ.landmark_stats_fused(*map(jnp.asarray, (qt, kt, k, v)), bs=64,
                                       interpret=True)
    for W, BmV in (RT.landmark_stats_ref(*_t(qt, kt, k, v)),
                   OT.landmark_stats_fused(*_t(qt, kt, k, v))):
        assert W.shape == (L, L) and BmV.shape == (L, Dv)
        for ref_w, ref_b in ((W_ref, B_ref), (W_k, B_k)):
            np.testing.assert_allclose(W.numpy(), np.asarray(ref_w), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(BmV.numpy(), np.asarray(ref_b), rtol=1e-5, atol=1e-5)


def test_landmark_stats_masks_match_reference_padding():
    """The plain version's n_valid/l_valid masks reproduce the reference
    kernel on inputs it pads itself: padded keys and landmark columns carry
    no weight."""
    S, L, Dh, Dv = 100, 11, 16, 12
    qt, kt, k, v = _inputs(7, (L, Dh), (L, Dh), (S, Dh), (S, Dv))
    W_k, B_k = OJ.landmark_stats_fused(*map(jnp.asarray, (qt, kt, k, v)), bs=64,
                                       interpret=True)
    kp = np.concatenate([k, np.ones((28, Dh), np.float32)])
    vp = np.concatenate([v, np.ones((28, Dv), np.float32)])
    ktp = np.concatenate([kt, np.ones((5, Dh), np.float32)])
    qtp = np.concatenate([qt, np.ones((5, Dh), np.float32)])
    W, BmV = RT.landmark_stats_ref(*_t(qtp, ktp, kp, vp), n_valid=S, l_valid=L)
    np.testing.assert_allclose(W[:L, :L].numpy(), np.asarray(W_k), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(BmV[:L].numpy(), np.asarray(B_k), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [1, 4])
def test_accum_attention_kernel_matches_reference(m):
    """The full pipeline (pools, fused stats, Newton–Schulz, F-stage) on the
    reference's make_seq_sketch draw, against the reference's Pallas
    pipeline and its XLA route, at 1e-4."""
    B, H, S, Dh = 2, 3, 128, 32
    q, k, v = _inputs(m, (B, H, S, Dh), (B, H, S, Dh), (B, H, S, Dh))
    skj = make_seq_sketch(jax.random.PRNGKey(m), S, 32, m)
    kern = np.asarray(OJ.accum_attention_kernel(*map(jnp.asarray, (q, k, v)), skj, bq=64,
                                                interpret=True))
    sk = interop.sketch_from_numpy(np.asarray(skj.indices), np.asarray(skj.signs),
                                   np.asarray(skj.probs), S, device="cpu")
    tq, tk, tv = _t(q, k, v)
    for got in (OT.accum_attention_kernel(tq, tk, tv, sk),
                accum_attention(tq, tk, tv, sk, use_kernel=True),
                accum_attention(tq, tk, tv, sk)):
        np.testing.assert_allclose(got.numpy(), kern, rtol=1e-4, atol=1e-4)


def test_kernel_dispatch_fault_raises_and_never_degrades(monkeypatch):
    """An armed kernel.dispatch error reaches the caller of the kernel
    route: the port has no ladder down to the plain route."""
    from repro_torch.resilience import faults

    q = torch.zeros((1, 1, 16, 8))
    sk = interop.sketch_from_numpy(np.arange(8)[None], np.ones((1, 8)),
                                   np.full(16, 1 / 16), 16, device="cpu")
    monkeypatch.setenv(faults.ENV_PLAN, '{"kernel.dispatch": {"action": "error", "at": 1}}')
    faults.reset()
    with pytest.raises(faults.FaultInjected):
        accum_attention(q, q, q, sk, use_kernel=True)
    faults.reset()
