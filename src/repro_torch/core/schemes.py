"""Sampling schemes for accumulation sketches — the ``scheme=`` knob.

  * ``"uniform"``  — p_i = 1/n, the default everywhere.
  * ``"leverage"`` — ridge-leverage-score probabilities estimated from the
    current sketch itself: the Nyström lift of (C, W)
    (``spectral.nystrom_eigh``) gives K̂ = P Σ² Pᵀ, and
    ℓ̂_i = Σ_j P_ij² σ²_j/(σ²_j + nλ) — O(n·d²), no n×n matrix.  The
    progressive engine refines the probabilities as m grows
    (``refresh_tail`` redraws the slabs not yet accumulated).
    ``core.leverage`` is the exact O(n³) oracle the tests compare against.
  * ``"poisson"``  — each row enters a slab independently with probability
    π_i = min(1, d·p_i), padded or cut to the column budget d.  The stored
    per-row probability is π_i/d, so the combination coefficient
    r/√(d·m·p) is the Horvitz–Thompson r/√(m·π).

Each random draw is split from the arithmetic that uses it
(``poisson_select``, ``replace_tail``), so that a test can feed the
reference's draws through the port's arithmetic.
"""
from __future__ import annotations

import dataclasses

import torch

SCHEMES = ("uniform", "leverage", "poisson")

# floor for Poisson inclusion probabilities: keeps π/d strictly positive so
# padding columns (sign 0) never divide 0/√0 into NaN in the coef formula
_PI_FLOOR = 1e-9


def validate_scheme(scheme: str) -> str:
    """Check ``scheme`` is one of ``SCHEMES`` and return it."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; expected one of {SCHEMES}")
    return scheme


def _rademacher(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    bits = torch.randint(0, 2, shape, generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(dtype)


# --------------------------------------------------------------------------- #
# Poisson sampling
# --------------------------------------------------------------------------- #

def poisson_inclusion(probs, n: int, d: int, dtype=torch.float32,
                      device="cpu") -> torch.Tensor:
    """Per-row inclusion probabilities π_i = min(1, d·p_i), floored at 1e-9;
    ``probs=None`` means uniform, unnormalized weights are accepted."""
    from repro_torch.core.sketch import _normalize_probs

    base = _normalize_probs(probs, n, dtype, device)
    return torch.clamp(d * base, _PI_FLOOR, 1.0)


def poisson_select(u: torch.Tensor, sgn: torch.Tensor, pi: torch.Tensor,
                   d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The Poisson slabs for given uniforms ``u`` (m, n) and signs ``sgn``
    (m, d): row i enters slab s when u[s, i] < π_i.  Where a slab holds more
    than d rows, the d with the smallest u/π (uniform given inclusion) are
    kept and √(N/d) is folded into their signs, so the slab stays unbiased;
    where it holds fewer, the trailing columns carry sign 0.

    Returns ``(indices (m, d) int32, signs (m, d))``."""
    inc = u < pi[None, :]
    score = torch.where(inc, u / pi[None, :], torch.inf)
    order = torch.argsort(score, dim=1, stable=True)
    indices = order[:, :d].to(torch.int32)
    count = inc.sum(dim=1)                              # N per slab
    kept = torch.clamp(count, max=d)
    valid = torch.arange(d, device=u.device)[None, :] < kept[:, None]
    scale = torch.sqrt(count.clamp_min(1) / kept.clamp_min(1)).to(sgn.dtype)
    return indices, torch.where(valid, sgn * scale[:, None], 0.0)


def poisson_pieces(generator: torch.Generator, pi: torch.Tensor, m: int,
                   d: int, *, dtype=torch.float32, signed: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw ``m`` Poisson slabs with inclusion probabilities π on the
    generator's device (``poisson_select`` does the arithmetic).  Returns
    ``(indices, signs)`` of shape (m, d); sign 0 marks padding."""
    gdev = generator.device
    u = torch.rand((m, pi.shape[0]), generator=generator, device=gdev)
    sgn = (_rademacher(generator, (m, d), dtype) if signed
           else torch.ones((m, d), dtype=dtype, device=gdev))
    return poisson_select(u, sgn, pi.to(gdev), d)


# --------------------------------------------------------------------------- #
# Sketch-estimated ridge leverage scores
# --------------------------------------------------------------------------- #

def sketch_leverage_scores(C: torch.Tensor, W: torch.Tensor, lam: float, *,
                           eps: float = 1e-7) -> torch.Tensor:
    """Ridge leverage scores of the sketched operator K̂ = C W⁺ Cᵀ, O(n·d²):
    ℓ̂_i = Σ_j P_ij² σ²_j/(σ²_j + nλ) from the Nyström lift K̂ = P Σ² Pᵀ,
    in the K/n eigenvalue convention of ``leverage.leverage_scores``."""
    from repro_torch.core.spectral import nystrom_eigh

    n = C.shape[0]
    evals, evecs = nystrom_eigh(C.float(), W.float(), eps=eps)
    ratio = evals / (evals + n * lam)
    return torch.einsum("nk,k->n", evecs * evecs, ratio)


def sketch_leverage_probs(C: torch.Tensor, W: torch.Tensor, lam: float, *,
                          mix: float = 0.1, eps: float = 1e-7) -> torch.Tensor:
    """Sampling probabilities (1−mix)·ℓ̂/Σℓ̂ + mix/n from sketch-estimated
    leverage scores; the uniform floor keeps every p_i ≥ mix/n."""
    scores = sketch_leverage_scores(C, W, lam, eps=eps)
    n = scores.shape[0]
    total = torch.clamp_min(scores.sum(), 1e-30)
    return (1.0 - mix) * scores / total + mix / n


def state_leverage_probs(state, lam: float, *, mix: float = 0.1,
                         eps: float = 1e-7) -> torch.Tensor:
    """Refined sampling probabilities from a live engine state: W = SᵀC is
    recomputed from C by row gathers (not read from ``state.W``), as the
    reference does so that engines whose W sums in another order feed the
    same numbers into the refresh."""
    from repro_torch.core import apply as A

    sk = state.masked_sketch()
    C = state.C[: state.n].float()
    W = A.sketch_left(sk, C)
    W = 0.5 * (W + W.T)
    return sketch_leverage_probs(C, W, lam, mix=mix, eps=eps)


def replace_tail(state, idx_f: torch.Tensor, sgn_f: torch.Tensor,
                 probs_new: torch.Tensor):
    """The state with the slabs ≥ m replaced by the (m_max, d) draw
    ``idx_f``/``sgn_f`` from ``probs_new``: slabs < m keep their indices,
    signs and at-draw probabilities (already folded into (C, W)); the tail
    records the new probabilities."""
    dev = state.indices.device
    idx_f, sgn_f = idx_f.to(dev, torch.int32), sgn_f.to(dev, state.signs.dtype)
    probs_new = probs_new.to(dev)
    tail = torch.arange(state.m_max, device=dev)[:, None] >= state.m
    p_f = probs_new[idx_f.long()].to(state.pdraw.dtype)
    return dataclasses.replace(
        state,
        indices=torch.where(tail, idx_f, state.indices),
        signs=torch.where(tail, sgn_f, state.signs),
        probs=probs_new.to(state.probs.dtype),
        pdraw=torch.where(tail, p_f, state.pdraw),
    )


def refresh_tail(state, generator: torch.Generator, probs_new: torch.Tensor,
                 *, signed: bool = True):
    """Redraw the slabs not yet accumulated from ``probs_new``, with
    replacement, on the generator's device (``replace_tail`` does the
    rest)."""
    gdev = generator.device
    m_max, d = state.indices.shape
    idx_f = torch.multinomial(probs_new.to(gdev, torch.float64), m_max * d,
                              replacement=True,
                              generator=generator).reshape(m_max, d)
    sgn_f = (_rademacher(generator, (m_max, d), state.signs.dtype) if signed
             else torch.ones((m_max, d), dtype=state.signs.dtype, device=gdev))
    return replace_tail(state, idx_f, sgn_f, probs_new)
