"""The work each computation needs, counted from its shapes.

These count the computation, not the implementation that does it: inputs
read once, outputs written once, and the fewest FLOPs of a plain statement
of the algorithm (a symmetric Gram counts its d(d+1)/2 distinct entries).
An implementation that does more (a full Gram, an SVD in place of an eigh,
TF32 splits) reads as a lower share of the peak, never a higher one.

A floating-point multiply-add is 2 FLOPs.  An eigendecomposition of a d×d
symmetric matrix with its vectors counts (4/3)d³ for the reduction to
tridiagonal form and 2d³ for the back-transformation.
"""
from __future__ import annotations

from portbench.yardstick import peaks

F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds for the work: bytes at the HBM rate or FLOPs at the
    TF32 tensor-core rate, whichever is larger."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.TF32_FLOPS_PER_S)


def matfree(rows: int, p: int, m: int, d: int) -> tuple[float, float]:
    """(FLOPs, bytes) of C = K(X, L)·S for ``rows`` rows of p features and
    the m·d sampled rows L: each of rows·m·d kernel entries takes the dot
    product x·l (p multiply-adds, 2p; the squared norms are per row and per
    landmark), the scaled exponent (1) and the multiply-add into its column
    sum (2), so 2p + 3; X, L and the coefficients are read once and C
    written once, in float32."""
    md = m * d
    flops = rows * md * (2 * p + 3)
    nbytes = F32 * (rows * p + md * p + md + rows * d)
    return float(flops), float(nbytes)


def gram(n: int, d: int) -> float:
    """FLOPs of the symmetric CᵀC for C (n, d)."""
    return float(n * d * (d + 1))


def cholesky(d: int) -> float:
    """FLOPs of a d×d Cholesky factorisation."""
    return d ** 3 / 3.0


def eigh(d: int) -> float:
    """FLOPs of a d×d symmetric eigendecomposition with its vectors."""
    return (4.0 / 3.0 + 2.0) * d ** 3


def krr_pcg_fit(n: int, p: int, m: int, d: int, iters: int) -> float:
    """FLOPs of a sketched fit by ``iters`` preconditioned CG iterations: C,
    W, the Cholesky of W, Cᵀy; an iteration is C·p and Cᵀ(·) (4nd), W·p
    (2d²), the preconditioner's two triangular solves (2d²) and five
    d-vector updates (10d); then the fitted values Cθ (2nd)."""
    it = 4.0 * n * d + 4.0 * d * d + 10.0 * d
    return (matfree(n, p, m, d)[0] + 2.0 * m * d * d + cholesky(d) + 2.0 * n * d
            + iters * it + 2.0 * n * d)


def spectral_cluster(n: int, p: int, m: int, d: int, k: int, restarts: int,
                     iters: int) -> float:
    """FLOPs of a sketched spectral clustering into k clusters: C and W; W's
    eigendecomposition; the degrees C·(W⁺·(Cᵀ1)) (4nd + 4d²) and the scaling
    of C (nd); the Gram of the scaled C; its d×d eigendecomposition; the k
    eigenvectors' lift (2ndk) and their rows' normalisation (3nk); then
    k-means on the (n, k) embedding: per restart, k-means++ seeding (3nk per
    centre) and, per Lloyd iteration, the distances and the centroid sums
    (4nk² + 2nk), and the final assignment (2nk²)."""
    embed = (matfree(n, p, m, d)[0] + 2.0 * m * d * d + eigh(d) + 4.0 * n * d
             + 4.0 * d * d + n * d + gram(n, d) + eigh(d) + 2.0 * n * d * k
             + 3.0 * n * k)
    lloyd = restarts * (k * 3.0 * n * k + iters * (4.0 * n * k * k + 2.0 * n * k))
    return embed + lloyd + 2.0 * n * k * k
