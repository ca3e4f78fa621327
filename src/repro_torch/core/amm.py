"""Approximate matrix multiplication with accumulation sketches — the extension
the paper proposes in its conclusion ("applying the proposed sketching method to
approximate matrix multiplication").

For A (n, p), B (n, q):   Aᵀ B ≈ (Sᵀ A)ᵀ (Sᵀ B) = Aᵀ S Sᵀ B,
unbiased because E[S Sᵀ] = I_n for Algorithm-1 sketches (any P, any m).
Cost O(m·d·(p+q) + d·p·q) instead of O(n·p·q).
"""
from __future__ import annotations

import torch

from repro_torch.core.apply import sketch_left
from repro_torch.core.sketch import AccumSketch


def amm(A: torch.Tensor, B: torch.Tensor, sk: AccumSketch) -> torch.Tensor:
    """Sketched estimate of Aᵀ B."""
    SA = sketch_left(sk, A)       # (d, p)
    SB = sketch_left(sk, B)       # (d, q)
    return SA.T @ SB


def amm_error(A: torch.Tensor, B: torch.Tensor, sk: AccumSketch) -> torch.Tensor:
    """Relative Frobenius error vs the exact product (diagnostic)."""
    exact = A.T @ B
    err = amm(A, B, sk) - exact
    return torch.linalg.norm(err) / (torch.linalg.norm(exact) + 1e-30)
