"""Plain PyTorch versions of the accum_apply kernels — the CPU route of every
wrapper in ``ops`` and the oracle the CUDA kernels are held against.

out[r, j] = Σ_{i<m} coef[i, j] · K[r, idx[i, j]]
"""
from __future__ import annotations

import torch


def accum_apply_ref(K: torch.Tensor, idx: torch.Tensor,
                    coef: torch.Tensor) -> torch.Tensor:
    """K: (R, N); idx: (m, d) int32 in [0, N); coef: (m, d).  Returns K S
    (R, d) in K's dtype, accumulated in float32."""
    cols = K.index_select(1, idx.reshape(-1))                   # (R, m·d)
    cols = cols.reshape(K.shape[0], *idx.shape)                 # (R, m, d)
    return torch.einsum("rmd,md->rd", cols.float(), coef.float()).to(K.dtype)


def landmark_cols_ref(Xq: torch.Tensor, landmarks: torch.Tensor,
                      coef: torch.Tensor, kernel_fn) -> torch.Tensor:
    """K(Xq, landmarks)·Cmat in one unchunked pass: the (nq, m·d) kernel slab
    against the landmark rows, contracted with the (m, d) coefficients.
    Accumulates in float32 at least (float64 inputs stay float64)."""
    m, d = coef.shape
    acc_t = torch.promote_types(torch.float32,
                                torch.promote_types(Xq.dtype, coef.dtype))
    slab = kernel_fn(Xq, landmarks).to(acc_t)                   # (nq, m·d)
    slab = slab.reshape(Xq.shape[0], m, d)
    return torch.einsum("nmd,md->nd", slab, coef.to(acc_t))


def matfree_cols_ref(X: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor,
                     kernel_fn) -> torch.Tensor:
    """Oracle for the matrix-free kernel: C = K(X, X)·S from the data rows,
    through the full (n, m·d) slab against the gathered landmarks."""
    landmarks = X.index_select(0, idx.reshape(-1))              # (m·d, p)
    return landmark_cols_ref(X, landmarks, coef, kernel_fn)


def sketch_left_ref(idx: torch.Tensor, coef: torch.Tensor,
                    M: torch.Tensor) -> torch.Tensor:
    """Sᵀ M via row gather + contraction:
    out[j, :] = Σ_{i<m} coef[i, j] · M[idx[i, j], :].  Returns float32."""
    rows = M.index_select(0, idx.reshape(-1))                   # (m·d, c)
    rows = rows.reshape(*idx.shape, M.shape[-1])                # (m, d, c)
    return torch.einsum("mdc,md->dc", rows.float(), coef.float())


def sketch_both_ref(K: torch.Tensor, idx: torch.Tensor,
                    coef: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """C = K S, W = Sᵀ C, with W folded from the float32 C before C is cast
    to K's dtype.  Returns (C in K.dtype, W in float32)."""
    C32 = accum_apply_ref(K.float(), idx, coef)
    return C32.to(K.dtype), sketch_left_ref(idx, coef, C32)


def accum_step_ref(K: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor,
                   Cin: torch.Tensor, a: float) -> torch.Tensor:
    """One progressive step a·Cin + K·T̃ for the slab idx/coef (1, d): the
    float32 G plus the float32 rescaled Cin, cast to Cin's dtype (AA:263)."""
    G = accum_apply_ref(K.float(), idx, coef)
    return (a * Cin.float() + G).to(Cin.dtype)


def accum_grow_ref(K: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor,
                   Cin: torch.Tensor, a: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold the B-slab block T (idx/coef of shape (B, d), coefficients at the
    grown normalization) into the running C with survivor rescale ``a``:

        C_new = a·Cin + G,   TᵀG = Tᵀ K T,   TᵀC = Tᵀ Cin,   G = K·T,

    all three from float32 values; C_new is cast to Cin's dtype.  The caller
    assembles W_new = a²W + a(TᵀC + TᵀCᵀ) + TᵀG."""
    G = accum_apply_ref(K.float(), idx, coef)
    C_new = a * Cin.float() + G
    return (C_new.to(Cin.dtype), sketch_left_ref(idx, coef, G),
            sketch_left_ref(idx, coef, Cin))
