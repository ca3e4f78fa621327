"""Sketched kernel ridge regression, written out plainly.

    C = K(X, L)·S      (n, d), the Gaussian kernel between the rows and the
                        m·d sampled rows L = X[idx], contracted slab by slab
    W = Sᵀ C           (d, d), the sampled rows of C combined by the same
                        coefficients, symmetrised
    (CᵀC + nλ W) θ = Cᵀy,   fitted = C θ

``pcg`` runs the Woodbury system by conjugate gradients preconditioned with
the Cholesky of W (FALKON's recipe); ``cholesky_ladder`` solves it exactly,
by Cholesky with the jitter 1e-8·tr(M)/d raised tenfold while the
factorisation fails (at most three times), as the paper's solver states it.

Everything runs in the dtype of the inputs given (float64 for the reference;
float32 with TF32 products for the control), in blocks of rows so that no
(n, m·d) slab exists at once.
"""
from __future__ import annotations

import torch


def gaussian_cols(Xq: torch.Tensor, L: torch.Tensor, coef: torch.Tensor,
                  bandwidth: float, block: int = 2048) -> torch.Tensor:
    """K(Xq, L)·S: (nq, d) from the rows Xq (nq, p), the sampled rows
    L (m·d, p), slab i·d + j feeding column j, and coef (m, d)."""
    m, d = coef.shape
    l2 = (L * L).sum(1)
    out = torch.empty((Xq.shape[0], d), dtype=Xq.dtype, device=Xq.device)
    inv = 1.0 / (2.0 * bandwidth * bandwidth)
    for lo in range(0, Xq.shape[0], block):
        xb = Xq[lo:lo + block]
        d2 = ((xb * xb).sum(1)[:, None] + l2[None, :] - 2.0 * (xb @ L.T)).clamp_min_(0.0)
        k = torch.exp_(d2.mul_(-inv)).view(xb.shape[0], m, d)
        out[lo:lo + block] = (k * coef[None]).sum(1)
        del d2, k
    return out


def sketch_left(idx: torch.Tensor, coef: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Sᵀ C (d, c): row j is Σ_i coef[i, j]·C[idx[i, j]]."""
    m, d = idx.shape
    rows = C.index_select(0, idx.reshape(-1)).view(m, d, C.shape[1])
    return (rows * coef[:, :, None]).sum(0)


def gram(C: torch.Tensor, block: int = 65536) -> torch.Tensor:
    """CᵀC, summed over blocks of rows."""
    G = torch.zeros((C.shape[1], C.shape[1]), dtype=C.dtype, device=C.device)
    for lo in range(0, C.shape[0], block):
        cb = C[lo:lo + block]
        G += cb.T @ cb
    return G


def cholesky_ladder(M: torch.Tensor, b: torch.Tensor, escalations: int = 3
                    ) -> tuple[torch.Tensor, int]:
    """(x, jitter rises) for M x = b: Cholesky with jitter 1e-8·tr(M)/d,
    raised tenfold on a failed factorisation or a non-finite solution."""
    d = M.shape[0]
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    j0 = 1e-8 * (torch.trace(M) / d + 1e-30)
    for level in range(escalations + 1):
        L, info = torch.linalg.cholesky_ex(M + (j0 * 10.0 ** level) * eye)
        x = torch.cholesky_solve(b[:, None], L)[:, 0]
        if int(info) == 0 and bool(torch.isfinite(x).all()):
            return x, level
    return torch.linalg.lstsq(M + j0 * eye, b[:, None]).solution[:, 0], escalations + 1


def pcg(C: torch.Tensor, W: torch.Tensor, y: torch.Tensor, lam: float, iters: int,
        tol: float = 1e-7) -> dict:
    """Preconditioned CG on (CᵀC + nλW) θ = Cᵀy from θ = 0, preconditioned by
    (nλ (W + 1e-8·tr(W)/d·I))⁻¹; stops when ‖r‖² ≤ tol²‖Cᵀy‖² or after
    ``iters`` iterations."""
    n, d = C.shape
    eye = torch.eye(d, dtype=W.dtype, device=W.device)
    L = torch.linalg.cholesky(W + 1e-8 * (torch.trace(W) / d + 1e-30) * eye)
    nlam = n * lam

    def matvec(t):
        return C.T @ (C @ t) + nlam * (W @ t)

    def precond(r):
        return torch.cholesky_solve(r[:, None], L)[:, 0] / nlam

    b = C.T @ y
    atol2 = float(tol ** 2 * (b @ b))
    x = torch.zeros_like(b)
    r = b.clone()
    z = precond(r)
    p = z
    gamma = r @ z
    done = 0
    for _ in range(iters):
        if not float(r @ r) > atol2:
            break
        Ap = matvec(p)
        alpha = gamma / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        gamma_new = r @ z
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        done += 1
    return {"theta": x, "fitted": C @ x, "iters": done}


def m_norm(M: torch.Tensor, v: torch.Tensor) -> float:
    """sqrt(vᵀ M v) for the system matrix M."""
    return float(torch.sqrt(torch.clamp_min(v @ (M @ v), 0.0)))
