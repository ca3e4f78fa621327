"""The plain reference against direct float64 computations at a tiny n: the
sketch drawn again, the kernel columns, the exact and PCG solves, the
spectral embedding, and the comparison of spans."""
from __future__ import annotations

import math

import torch

from portbench.reference import krr as R
from portbench.reference import sketch as RS
from portbench.reference import spectral as RSp


def _data(n=300, p=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((n, p), generator=g, dtype=torch.float64)
    y = torch.sin(X[:, 0]) + 0.1 * torch.randn(n, generator=g, dtype=torch.float64)
    return X, y


def _dense(idx, coef, n):
    S = torch.zeros((n, coef.shape[1]), dtype=torch.float64)
    for i in range(coef.shape[0]):
        for j in range(coef.shape[1]):
            S[idx[i, j], j] += coef[i, j]
    return S


def _K(A, B, bw):
    return torch.exp(-torch.cdist(A, B) ** 2 / (2 * bw * bw))


def test_sketch_matches_the_program_draw():
    from repro_torch.core.sketch import make_accum_sketch

    for seed in (3, 2**40 + 1):
        sk = make_accum_sketch(torch.Generator().manual_seed(seed), 1000, 16, 4, device="cpu")
        idx, coef = RS.uniform_signed(torch.Generator().manual_seed(seed), 1000, 16, 4)
        assert torch.equal(idx.int(), sk.indices)
        assert torch.allclose(coef, sk.coef.double(), rtol=1e-6)
        assert torch.all(coef.abs() == math.sqrt(1000 / 64))


def test_columns_and_left_apply_match_dense():
    X, _ = _data()
    idx, coef = RS.uniform_signed(torch.Generator().manual_seed(1), 300, 12, 3)
    S = _dense(idx, coef, 300)
    C = R.gaussian_cols(X, X[idx.reshape(-1)], coef, 1.5, block=64)
    K = _K(X, X, 1.5)
    assert torch.allclose(C, K @ S, atol=1e-12)
    assert torch.allclose(R.sketch_left(idx, coef, C), S.T @ K @ S, atol=1e-12)
    assert torch.allclose(R.gram(C, block=7), C.T @ C, atol=1e-10)


def test_ladder_and_pcg_solve_the_sketched_system():
    X, y = _data()
    idx, coef = RS.uniform_signed(torch.Generator().manual_seed(2), 300, 20, 4)
    S = _dense(idx, coef, 300)
    K = _K(X, X, 1.5)
    lam = 1e-3
    C, W = K @ S, S.T @ K @ S
    M = C.T @ C + 300 * lam * W
    direct = torch.linalg.solve(M + 1e-8 * torch.trace(M) / 20 * torch.eye(20), C.T @ y)
    exact, rises = R.cholesky_ladder(M, C.T @ y)
    assert rises == 0
    assert torch.allclose(exact, direct, rtol=1e-8)
    pcg = R.pcg(C, W, y, lam, iters=200, tol=1e-12)
    assert torch.allclose(pcg["fitted"], C @ pcg["theta"])
    assert R.m_norm(M, pcg["theta"] - exact) / R.m_norm(M, exact) < 1e-6
    few = R.pcg(C, W, y, lam, iters=2)
    assert few["iters"] == 2
    assert R.m_norm(M, few["theta"] - exact) > R.m_norm(M, pcg["theta"] - exact)


def test_ladder_rises_on_an_indefinite_matrix():
    M = torch.diag(torch.tensor([1.0, 1.0, -1e-7], dtype=torch.float64))
    x, rises = R.cholesky_ladder(M, torch.ones(3, dtype=torch.float64))
    assert rises == 2 and torch.isfinite(x).all()


def test_embedding_matches_dense_normalised_affinity():
    X, _ = _data(n=200, p=3, seed=4)
    n, d, k = 200, 40, 4
    idx, coef = RS.uniform_signed(torch.Generator().manual_seed(5), n, d, 3)
    S = _dense(idx, coef, n)
    K = _K(X, X, 2.0)
    C, W = K @ S, S.T @ K @ S
    ev, emb = RSp.embedding(C, W, k)
    Kh = C @ torch.linalg.pinv(W, hermitian=True, rtol=1e-7) @ C.T
    deg = Kh.sum(1)
    A = Kh / torch.sqrt(deg[:, None] * deg[None, :])
    w, V = torch.linalg.eigh(A)
    assert torch.allclose(ev, w.flip(0)[:k], rtol=1e-6)
    top = V.flip(1)[:, :k]
    top = top / top.norm(dim=1, keepdim=True)
    assert RSp.subspace_sin(emb, top) < 1e-6
    assert torch.allclose(emb.norm(dim=1), torch.ones(n, dtype=torch.float64))


def test_subspace_sine_ignores_the_basis():
    g = torch.Generator().manual_seed(6)
    Q = torch.linalg.qr(torch.randn((4, 4), generator=g, dtype=torch.float64))[0]
    B = torch.randn((30, 4), generator=g, dtype=torch.float64)
    assert RSp.subspace_sin(B, B @ Q) < 1e-7
    assert RSp.subspace_sin(B[:, :2], B[:, 2:]) > 0.1


def test_splitmix_matches_the_programs_stream_seed():
    from repro_torch._util import _mix

    for seed, tag in ((0, 0x4B3A), (2**33 + 9, 0x4B3A), (2**63, 1)):
        assert RS.splitmix64(seed, tag) == _mix(seed, tag)
