"""The decode sweep of ``landmark_attention`` (S ≤ 8 query rows a problem).

Its key partition is computed on the host (``kernel.plan``) and walked by
the CUDA kernel, so its invariants are held here on the CPU: a function of
the shape alone, every key in exactly one (split, warp) run, every block
with a key, runs whole multiples of the keys a warp reads at once.  Then the decode entry point (the plain version
on CPU tensors) against the reference's interpret-mode kernel at decode
shapes, with the tolerance of tests/test_kernels.py:235 (1e-5; both sum in
float32, in other orders).  The kernel itself is held against the plain
version on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.landmark_attention import ops as OJ  # noqa: E402
from repro_torch.kernels.accum_apply import autotune as AT  # noqa: E402
from repro_torch.kernels.landmark_attention import kernel as LK  # noqa: E402
from repro_torch.kernels.landmark_attention import ops as OT  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
KEYS = (1, 3, 4, 7, 8, 9, 31, 63, 64, 65, 100, 513, 1000, 1024, 4097, 32768)
PROBLEMS = (1, 3, 32, 256)
VALUE_DIMS = (5, 128, 200)


def _runs(P, S, Lk, Dv, Dh, dtype, min_split=1):
    """(split, warp, first key, end) of every warp of the decode sweep's
    launch that has keys, in launch order: warp w of split s walks the
    ``per`` keys from (s·W + w)·per, cut at Lk, as the csrc's
    ``attend_decode_kernel`` computes them from ``kernel.plan``."""
    nsplit, run = LK.plan(P, S, Lk, Dv, Dh, dtype, min_split=min_split)
    out = []
    for s in range(nsplit):
        for w in range(LK.DECODE_WARPS):
            k0 = (s * LK.DECODE_WARPS + w) * run
            if k0 < Lk:
                out.append((s, w, k0, min(k0 + run, Lk)))
    return out


@pytest.mark.parametrize("min_split", [1, 2])
@pytest.mark.parametrize("S", range(1, 9))
def test_decode_plan_partitions_every_key_once(S, min_split):
    """Over a sweep of problems, key counts and value widths: the runs
    cover 0 .. Lk − 1 once each, in key order; each is ``per`` keys (the
    last cut at Lk), a whole number of ``DECODE_RUN``, which every batch a
    warp reads divides; every split's first warp holds a key, so every
    block of the launch has one; there are at most ``DECODE_MAX_SPLITS``
    splits, and at least ``min_split`` wherever each can hold a run."""
    assert LK.decode_rows(S) >= S
    for Dh in (64, 128, 256):
        batch = LK.decode_batch(S, Dh)
        assert LK.DECODE_RUN % batch == 0 and LK.key_tile(S, Dh, F32) == batch
        assert batch * LK.decode_rows(S) * (2 if Dh > 128 else 1) <= 32
    for P in PROBLEMS:
        for Lk in KEYS:
            for Dv in VALUE_DIMS:
                nsplit, per = LK.plan(P, S, Lk, Dv, 128, F32, min_split=min_split)
                runs = _runs(P, S, Lk, Dv, 128, F32, min_split=min_split)
                assert per % LK.DECODE_RUN == 0 and per > 0
                assert nsplit <= LK.DECODE_MAX_SPLITS
                covered = [k for _, _, k0, k1 in runs for k in range(k0, k1)]
                assert covered == list(range(Lk))
                assert all(k1 - k0 == per or k1 == Lk for _, _, k0, k1 in runs)
                assert {s for s, w, _, _ in runs if w == 0} == set(range(nsplit))
                assert [(s, w) for s, w, _, _ in runs] == sorted((s, w) for s, w, _, _ in runs)
                if Lk >= min_split * LK.DECODE_WARPS * LK.DECODE_RUN:
                    assert nsplit >= min_split


def test_decode_plan_is_a_function_of_the_shape(monkeypatch):
    """The same shape gives the same partition whatever else changes: the
    autotune gate and cache, the head dim and the dtype (the decode sweep
    reads a key row a step whatever its width), and the call's history —
    so two launches, and every geometry candidate, sum in the same order."""
    shapes = [(P, S, Lk, Dv) for P in (1, 32) for S in (1, 4, 8) for Lk in (100, 1024)
              for Dv in (128, 200)]
    want = {sh: LK.plan(*sh[:3], sh[3], 128, F32) for sh in shapes}
    for gate in ("0", "1"):
        monkeypatch.setenv(AT.ENV_GATE, gate)
        for (P, S, Lk, Dv), got in want.items():
            for Dh, dtype in ((64, F32), (128, BF16), (256, F32)):
                assert LK.plan(P, S, Lk, Dv, Dh, dtype) == got
                assert _runs(P, S, Lk, Dv, Dh, dtype) == _runs(P, S, Lk, Dv, 128, F32)
    assert LK.block_rows(4) == LK.DECODE_ROWS == (8,)


@pytest.mark.parametrize("S", [1, 3, 4, 8])
def test_decode_attend_matches_reference(S):
    """Decode shapes — S rows a problem over a slot count (100) that is no
    multiple of a warp's run, a block's or a split's, with a log-mass bias
    lane holding −1e30 for empty slots and one problem whose every slot is
    empty (uniform weights, finite) — through the port's entry point against
    the reference's interpret-mode kernel, problem by problem."""
    P, L, Dh, Dv = 3, 100, 16, 24
    rng = np.random.default_rng(S)
    q, kt, M = (rng.standard_normal(s).astype(np.float32)
                for s in ((P, S, Dh), (P, L, Dh), (P, L, Dv)))
    bias = np.log(rng.uniform(0.1, 3.0, (P, L))).astype(np.float32)
    bias[:, ::7] = -1e30
    bias[2] = -1e30
    got = OT.landmark_attend(*(torch.from_numpy(x) for x in (q, kt, M, bias))).numpy()
    assert got.shape == (P, S, Dv) and np.isfinite(got).all()
    for p in range(P):
        want = np.asarray(OJ.landmark_attend(*map(jnp.asarray, (q[p], kt[p], M[p], bias[p])),
                                             bq=64, interpret=True))
        np.testing.assert_allclose(got[p], want, rtol=1e-5, atol=1e-5)
