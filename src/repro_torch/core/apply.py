"""Structural application of an AccumSketch — the paper's efficiency claim.

The identities (paper §3.3):

    K S     = Σ_i K S_(i)          — O(n·m·d) instead of O(n²·d)
    Sᵀ K S  = Σ_i S_(i)ᵀ (K S)     — O(m·d²)  instead of O(n·d²)

Because each S_(i) has one non-zero per column, K S_(i) is a signed,
rescaled column gather of K, and S_(i)ᵀ M a row gather of M.  None of these
routines materializes S.  The progressive engine of the reference module is
still to be ported (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

import torch

from repro_torch.core.sketch import AccumSketch


def default_use_kernel(device) -> bool:
    """Whether a structural application on ``device`` takes the CUDA kernel:
    True on a CUDA device, False on the CPU (where the plain version runs)."""
    return torch.device(device).type == "cuda"


def _operator(K):
    """The KernelOperator behind K, or None for a dense tensor (lazy import:
    kernel_op imports this module)."""
    from repro_torch.core.kernel_op import KernelOperator

    return K if isinstance(K, KernelOperator) else None


def _common(*ts: torch.Tensor) -> torch.dtype:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def sketch_right(K: torch.Tensor, sk: AccumSketch) -> torch.Tensor:
    """K S for K of shape (r, n) → (r, d).  O(r·m·d)."""
    dt = _common(K, sk.coef)
    cols = K.index_select(1, sk.indices.reshape(-1))             # (r, m·d)
    cols = cols.reshape(K.shape[0], sk.m, sk.d)
    return torch.einsum("rmd,md->rd", cols.to(dt), sk.coef.to(dt))


def sketch_left(sk: AccumSketch, M: torch.Tensor) -> torch.Tensor:
    """Sᵀ M for M of shape (n, c) → (d, c).  O(m·d·c)."""
    dt = _common(M, sk.coef)
    rows = M.index_select(0, sk.indices.reshape(-1))             # (m·d, c)
    rows = rows.reshape(sk.m, sk.d, M.shape[-1])
    return torch.einsum("mdc,md->dc", rows.to(dt), sk.coef.to(dt))


def sketch_vec(sk: AccumSketch, v: torch.Tensor) -> torch.Tensor:
    """Sᵀ v for v of shape (n,) → (d,)."""
    return sketch_left(sk, v[:, None])[:, 0]


def unsketch_vec(sk: AccumSketch, w: torch.Tensor) -> torch.Tensor:
    """S w for w of shape (d,) → (n,) by scatter-add."""
    contrib = (sk.coef * w[None, :]).reshape(-1)                 # (m·d,)
    out = torch.zeros((sk.n,), dtype=contrib.dtype, device=w.device)
    return out.index_add_(0, sk.indices.reshape(-1), contrib)


def unsketch_mat(sk: AccumSketch, W: torch.Tensor) -> torch.Tensor:
    """S W for W of shape (d, c) → (n, c)."""
    contrib = sk.coef[..., None] * W[None, ...]                  # (m, d, c)
    out = torch.zeros((sk.n, W.shape[-1]), dtype=contrib.dtype, device=W.device)
    return out.index_add_(0, sk.indices.reshape(-1),
                          contrib.reshape(-1, W.shape[-1]))


def sketch_both(K, sk: AccumSketch, *, use_kernel: bool | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(K S, Sᵀ K S) sharing the K S intermediate, as in the paper.

    ``K`` is a dense (n, n) tensor or a matrix-free ``KernelOperator``.
    ``use_kernel`` (default: whether K is on a CUDA device) computes the
    dense pair with the ``accum_sketch_both`` kernel; W then stays float32.
    An operator routes C through the matrix-free kernel instead."""
    op = _operator(K)
    if op is not None:
        return op.sketch_both(sk, use_kernel=use_kernel)
    if use_kernel is None:
        use_kernel = default_use_kernel(K.device)
    if use_kernel:
        from repro_torch.kernels.accum_apply.ops import sketch_both_kernel

        return sketch_both_kernel(K, sk)
    KS = sketch_right(K, sk)
    return KS, sketch_left(sk, KS)


def gram_sketch(sk: AccumSketch) -> torch.Tensor:
    """Sᵀ S (d, d) without materializing S: the m·d non-zeros are grouped by
    their row into the compressed (md, d) block B, and SᵀS = BᵀB."""
    idx = sk.indices.reshape(-1)
    cf = sk.coef.reshape(-1)
    col = torch.arange(sk.d, device=idx.device).repeat(sk.m)
    _, ranks = torch.unique(idx, return_inverse=True)
    B = torch.zeros((idx.shape[0], sk.d), dtype=cf.dtype, device=cf.device)
    B.index_put_((ranks, col), cf, accumulate=True)
    return B.T @ B


def sketch_kernel_cols(X: torch.Tensor, sk: AccumSketch, kernel_fn, *,
                       chunk: int | None = None) -> torch.Tensor:
    """C = K S without ever forming K: O(n·m·d) kernel evaluations, streamed
    over row chunks (``kernel_op.stream_cols``)."""
    from repro_torch.core.kernel_op import stream_cols

    landmarks = X.index_select(0, sk.indices.reshape(-1))        # (m·d, p)
    return stream_cols(X, landmarks, sk.coef, kernel_fn, chunk=chunk)
