"""K-satisfiability (paper Definition 3) — the property driving Theorem 6.

A sketch S is K-satisfiable for δ if
  ‖U₁ᵀ S Sᵀ U₁ − I_{d_δ}‖_op ≤ 1/2
  ‖Sᵀ U₂ Σ₂^{1/2}‖_op ≤ c √δ
where U₁ spans the top-d_δ eigenspace of K/n.  Used by tests to check
Theorem 8's (d, m) conditions empirically.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.leverage import KrrSpectrum, d_delta, spectrum
from repro_torch.core.sketch import AccumSketch


class KSatResult(NamedTuple):
    """Outcome of the K-satisfiability certificate (see ``ksat_check``)."""

    top_deviation: torch.Tensor  # ‖U₁ᵀSSᵀU₁ − I‖_op
    tail_norm: torch.Tensor      # ‖SᵀU₂Σ₂^{1/2}‖_op
    tail_bound: torch.Tensor     # c·√δ reference (c=1)
    satisfied: torch.Tensor      # bool for c = 2 (constant from the theorem)


def ksat_check(K: torch.Tensor, S_or_sketch, delta: float,
               spec: KrrSpectrum | None = None, c: float = 2.0) -> KSatResult:
    """K-satisfiability certificate for a drawn sketch: the top d_δ
    eigendirections must be near-isometrically preserved
    (‖U₁ᵀS SᵀU₁ − I‖ ≤ 1/2) and the spectral tail must stay small
    (‖SᵀU₂Σ₂^{1/2}‖ ≤ c√δ).  ``S_or_sketch`` is an ``AccumSketch`` or a
    dense (n, d) S."""
    spec = spec or spectrum(K)
    dd = max(d_delta(spec, delta), 1)
    S = S_or_sketch.dense() if isinstance(S_or_sketch, AccumSketch) else S_or_sketch
    S = S.to(torch.promote_types(S.dtype, spec.eigvecs.dtype))
    U1 = spec.eigvecs[:, :dd]
    U2 = spec.eigvecs[:, dd:]
    s2 = torch.sqrt(torch.clamp_min(spec.eigvals[dd:], 0.0))
    StU1 = S.T @ U1                                   # (d, d_δ)
    top = StU1.T @ StU1 - torch.eye(dd, dtype=S.dtype, device=S.device)
    top_dev = torch.linalg.matrix_norm(top, ord=2)
    tail = (S.T @ U2) * s2[None, :]                   # Sᵀ U₂ Σ₂^{1/2}
    tail_norm = torch.linalg.matrix_norm(tail, ord=2)
    bound = torch.sqrt(torch.tensor(delta, dtype=S.dtype, device=S.device))
    ok = (top_dev <= 0.5) & (tail_norm <= c * bound)
    return KSatResult(top_dev, tail_norm, bound, ok)
