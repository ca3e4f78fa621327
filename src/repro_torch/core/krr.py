"""Kernel ridge regression: exact (paper eq. 2) and sketched (paper eq. 3).

Exact:     f̂(x)   = K(x, X) (K + nλ I)⁻¹ Y
Sketched:  f̂_S(x) = K(x, X) S (SᵀK²S + nλ SᵀKS)⁻¹ SᵀK Y        (Woodbury form)

Every sketched entry point takes a dense K or a matrix-free
``KernelOperator``.  Routing mirrors the reference: an operator computes C
through the ``matfree_apply`` kernel and W through the plain gather; the raw
data path computes C through the plain ``stream_cols`` and W through the
``accum_apply_left`` kernel; a dense K goes through ``accum_sketch_both``.
Kernels run for tensors on a CUDA device (``use_kernel=None``).  The
adaptive fits are still to be ported (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import apply as A
from repro_torch.core.kernel_op import KernelOperator, stream_cols
from repro_torch.core.sketch import AccumSketch
from repro_torch.resilience.degrade import solve_psd_ladder


# --------------------------------------------------------------------------- #
# Exact KRR
# --------------------------------------------------------------------------- #

def krr_exact_fit(K: torch.Tensor, y: torch.Tensor, lam: float) -> torch.Tensor:
    """α = (K + nλI)⁻¹ y; fitted values are K @ α."""
    n = K.shape[0]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    return solve_psd_ladder(K + n * lam * eye, y.to(K.dtype))[0]


def krr_exact_fitted(K: torch.Tensor, y: torch.Tensor, lam: float) -> torch.Tensor:
    """Fitted values f̂ = K α of the exact KRR solve — the O(n³) reference
    every sketched error is measured against."""
    return K @ krr_exact_fit(K, y, lam)


# --------------------------------------------------------------------------- #
# Sketched KRR
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class SketchedKRR:
    """Fitted sketched-KRR model.  predict() is O(n_test · m · d).

    ``op`` carries the ``KernelOperator`` when the model was fit through one;
    predict then computes K(X_test, landmarks)·θ through the operator (the
    ``matfree_apply`` kernel on a CUDA device)."""

    theta: torch.Tensor                 # (d,) dual coefficients in sketch space
    sk: AccumSketch | None              # structural sketch (None for dense S)
    S_dense: torch.Tensor | None        # dense sketch (baselines)
    X_train: torch.Tensor | None
    kernel_fn: Callable | None
    fitted: torch.Tensor | None         # in-sample f̂_S(X) (n,)
    info: dict | None = None            # solve health
    op: KernelOperator | None = None    # matrix-free operator (predict routing)

    def predict(self, X_test: torch.Tensor) -> torch.Tensor:
        """Out-of-sample prediction K(X_test, landmarks) θ — never an
        n_test × n matrix.  Landmarks come from the training rows."""
        if self.op is not None and self.sk is not None:
            C_test = self.op.cross_cols(X_test, self.sk)
        elif self.sk is not None:
            if self.X_train is None or self.kernel_fn is None:
                raise ValueError("predict needs X_train and kernel_fn")
            lm = self.X_train.index_select(0, self.sk.indices.reshape(-1))
            C_test = stream_cols(X_test, lm, self.sk.coef, self.kernel_fn)
        else:
            if self.X_train is None or self.kernel_fn is None:
                raise ValueError("predict needs X_train and kernel_fn")
            C_test = self.kernel_fn(X_test, self.X_train) @ self.S_dense
        return C_test @ self.theta.to(C_test.dtype)


def _fit_from_C(C: torch.Tensor, W: torch.Tensor, y: torch.Tensor, lam: float):
    """Given C = K S (n, d) and W = SᵀKS (d, d), solve the Woodbury system.
    Returns (theta, fitted, solve-health)."""
    n = C.shape[0]
    dt = torch.promote_types(C.dtype, y.dtype)
    CtC = C.T @ C
    rhs = C.T.to(dt) @ y.to(dt)                # SᵀK Y  (K symmetric)
    M = CtC + n * lam * W                      # SᵀK²S + nλ SᵀKS
    theta, health = solve_psd_ladder(M, rhs.to(M.dtype))
    return theta, C @ theta.to(C.dtype), health


def krr_sketched_fit(K, y: torch.Tensor, lam: float, sk: AccumSketch,
                     X_train: torch.Tensor | None = None,
                     kernel_fn: Callable | None = None, *,
                     use_kernel: bool | None = None) -> SketchedKRR:
    """Structural path on K — a dense tensor or a ``KernelOperator``: C and W
    in one pass, O(n·m·d).  With an operator, predict() is wired up."""
    op = A._operator(K)
    C, W = A.sketch_both(K, sk, use_kernel=use_kernel)
    theta, fitted, health = _fit_from_C(C, W, y, lam)
    if op is not None:
        return SketchedKRR(theta, sk, None, op.X, op.kernel_fn, fitted,
                           info=health, op=op)
    return SketchedKRR(theta, sk, None, X_train, kernel_fn, fitted, info=health)


def krr_sketched_fit_dense(K: torch.Tensor, y: torch.Tensor, lam: float,
                           S: torch.Tensor, X_train: torch.Tensor | None = None,
                           kernel_fn: Callable | None = None) -> SketchedKRR:
    """Dense-sketch baseline path (Gaussian sketching, sparse RP): O(n²d)."""
    C = K @ S
    W = S.T @ C
    theta, fitted, health = _fit_from_C(C, W, y, lam)
    return SketchedKRR(theta, None, S, X_train, kernel_fn, fitted, info=health)


def _sketch_left_routed(sk: AccumSketch, C: torch.Tensor,
                        use_kernel: bool | None) -> torch.Tensor:
    """W = Sᵀ C through the ``accum_apply_left`` kernel (default on a CUDA
    device) or the plain gather."""
    if use_kernel is None:
        use_kernel = A.default_use_kernel(C.device)
    if use_kernel:
        from repro_torch.kernels.accum_apply.ops import sketch_left_kernel

        return sketch_left_kernel(sk, C).to(C.dtype)
    return A.sketch_left(sk, C)


def _matfree_pair(X, sk: AccumSketch, kernel_fn, chunk, use_kernel):
    """(C, W, X, kernel_fn) for the matrix-free fits: an operator computes C
    through its ``weighted_cols``; raw data through ``stream_cols``; W goes
    through ``_sketch_left_routed`` either way."""
    op = A._operator(X)
    if op is not None:
        C = op.sketch_cols(sk, chunk=chunk, use_kernel=use_kernel)
        X, kernel_fn = op.X, op.kernel_fn
    else:
        C = A.sketch_kernel_cols(X, sk, kernel_fn, chunk=chunk)
    W = _sketch_left_routed(sk, C, use_kernel)
    # symmetrize W: SᵀKS is symmetric in exact arithmetic
    return C, 0.5 * (W + W.T), X, kernel_fn, op


def krr_sketched_fit_matfree(X, y: torch.Tensor, lam: float, sk: AccumSketch,
                             kernel_fn: Callable | None = None, *,
                             chunk: int | None = None,
                             use_kernel: bool | None = None) -> SketchedKRR:
    """Matrix-free path: never forms K.  ``X`` is the raw (n, p) data with an
    explicit ``kernel_fn``, or a ``KernelOperator`` (kernel_fn omitted)."""
    C, W, X, kernel_fn, op = _matfree_pair(X, sk, kernel_fn, chunk, use_kernel)
    theta, fitted, health = _fit_from_C(C, W, y, lam)
    return SketchedKRR(theta, sk, None, X, kernel_fn, fitted, info=health, op=op)


def _pcg_solve(C: torch.Tensor, W: torch.Tensor, y: torch.Tensor, lam: float,
               iters: int, tol: float = 1e-7) -> torch.Tensor:
    """Preconditioned CG on the Woodbury system (CᵀC + nλ W) θ = Cᵀy with the
    Cholesky of (W + jitter) as preconditioner; never materializes CᵀC.

    Same iteration and stopping rule as ``jax.scipy.sparse.linalg.cg``: from
    θ = 0, stop when ‖r‖² ≤ tol²·‖Cᵀy‖² or after ``iters`` iterations."""
    n, d = C.shape
    jitter = 1e-8 * (torch.trace(W) / d + 1e-30)
    L = torch.linalg.cholesky(W + jitter * torch.eye(d, dtype=W.dtype,
                                                     device=W.device))
    nlam = n * lam

    def matvec(t):
        return C.T @ (C @ t) + nlam * (W @ t)

    def precond(r):
        # (nλ W)⁻¹ ≈ the dominant small-eigenvalue part of the operator
        return torch.cholesky_solve(r[:, None], L)[:, 0] / nlam

    b = C.T @ y.to(C.dtype)
    atol2 = float(tol**2 * (b @ b))
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = precond(r)
    p = z
    gamma = r @ z
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
    return x


def krr_sketched_fit_pcg(X, y: torch.Tensor, lam: float, sk: AccumSketch,
                         kernel_fn: Callable | None = None, *, iters: int = 30,
                         chunk: int | None = None,
                         use_kernel: bool | None = None) -> SketchedKRR:
    """Falkon-flavoured solver (Rudi et al. 2017) on the accumulation sketch:
    preconditioned CG on (CᵀC + nλ W) θ = Cᵀy, C = K S matrix-free,
    W = SᵀKS, with the Cholesky of the d×d W as preconditioner (paper §3.3).
    ``X``: raw data + ``kernel_fn``, or a ``KernelOperator``."""
    C, W, X, kernel_fn, op = _matfree_pair(X, sk, kernel_fn, chunk, use_kernel)
    theta = _pcg_solve(C, W, y, lam, iters)
    return SketchedKRR(theta, sk, None, X, kernel_fn, C @ theta, op=op)


def insample_error(f_a: torch.Tensor, f_b: torch.Tensor) -> torch.Tensor:
    """‖f_a − f_b‖_n² = (1/n) Σ_i (f_a(x_i) − f_b(x_i))²  (empirical L2 norm)."""
    diff = f_a - f_b
    return torch.mean(diff * diff)
