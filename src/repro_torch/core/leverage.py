"""Statistical leverage scores, statistical dimension, and the paper's
incoherence characteristic M (Theorem 8).

  ℓ_i   = (K (K + nλI)⁻¹)_ii
  d_stat = Σ ℓ_i = Σ σ_i/(σ_i + λ)        (σ_i = eigenvalues of K/n)
  M     = max( max_i ‖ψ̃_i‖²/p_i ,  max_i (‖ψ_i‖² − ‖ψ̃_i‖²)/p_i )

These are O(n³) diagnostics for experiments and tests — the exact oracle
the sketch-estimated leverage of ``core.schemes`` is held against.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KrrSpectrum(NamedTuple):
    """Eigendecomposition of K/n, shared by every oracle in this module."""

    eigvals: torch.Tensor   # σ_i of K/n, descending (n,)
    eigvecs: torch.Tensor   # U (n, n), columns matching eigvals


def spectrum(K: torch.Tensor) -> KrrSpectrum:
    """Full eigh of K/n (clipped to PSD, descending)."""
    n = K.shape[0]
    w, U = torch.linalg.eigh(K / n)
    order = torch.argsort(-w)
    return KrrSpectrum(torch.clamp_min(w[order], 0.0), U[:, order])


def leverage_scores(K: torch.Tensor, lam: float,
                    spec: KrrSpectrum | None = None) -> torch.Tensor:
    """ℓ_i = (K(K+nλI)⁻¹)_ii = Σ_j U_ij² σ_j/(σ_j+λ)."""
    spec = spec or spectrum(K)
    ratio = spec.eigvals / (spec.eigvals + lam)
    return torch.einsum("ij,j->i", spec.eigvecs**2, ratio)


def statistical_dimension(K: torch.Tensor, lam: float,
                          spec: KrrSpectrum | None = None) -> torch.Tensor:
    """d_stat(λ) = Σ_i σ_i/(σ_i + λ) = Σ_i ℓ_i."""
    spec = spec or spectrum(K)
    return torch.sum(spec.eigvals / (spec.eigvals + lam))


def d_delta(spec: KrrSpectrum, delta: float) -> int:
    """d_δ = the count of eigenvalues above δ."""
    return int(torch.sum(spec.eigvals > delta))


def incoherence(K: torch.Tensor, delta: float, probs=None,
                spec: KrrSpectrum | None = None) -> torch.Tensor:
    """The incoherence M of Theorem 8 under sampling distribution P (uniform
    default): ‖ψ_i‖² = Σ_j U_ij² σ_j/(σ_j+δ), split at d_δ."""
    spec = spec or spectrum(K)
    n = K.shape[0]
    if probs is None:
        probs = torch.full((n,), 1.0 / n, dtype=K.dtype, device=K.device)
    dd = d_delta(spec, delta)
    scale = spec.eigvals / (spec.eigvals + delta)
    psi_sq = spec.eigvecs**2 * scale[None, :]
    head = torch.sum(psi_sq[:, :dd], dim=1)
    tail = torch.sum(psi_sq[:, dd:], dim=1)
    return torch.maximum(torch.max(head / probs), torch.max(tail / probs))


def leverage_probs(K: torch.Tensor, lam: float,
                   spec: KrrSpectrum | None = None) -> torch.Tensor:
    """p_i ∝ ℓ_i — the leverage-based sampling distribution."""
    lev = torch.clamp_min(leverage_scores(K, lam, spec), 0.0)
    return lev / torch.sum(lev)


def approx_leverage_probs(generator: torch.Generator, K: torch.Tensor,
                          lam: float, sketch_dim: int) -> torch.Tensor:
    """BLESS-flavoured approximate leverage scores from a Nyström pilot of
    ``sketch_dim`` landmarks drawn without replacement on the generator's
    device: ℓ̂_i = (K_ii − k_{iS}(K_SS + nλI)⁻¹k_{Si})/(nλ), an
    over-estimate of ℓ_i(λ), O(n·s²)."""
    n = K.shape[0]
    idx = torch.randperm(n, generator=generator,
                         device=generator.device)[:sketch_dim].to(K.device)
    Knd = K.index_select(1, idx)                               # (n, s)
    Kdd = Knd.index_select(0, idx)                             # (s, s)
    reg = Kdd + n * lam * torch.eye(sketch_dim, dtype=K.dtype, device=K.device)
    sol = torch.linalg.solve(reg, Knd.T)                       # (s, n)
    proj = torch.einsum("ns,sn->n", Knd, sol)
    l_hat = torch.clamp((torch.diagonal(K) - proj) / (n * lam), 1e-12, 1.0)
    return l_hat / torch.sum(l_hat)
