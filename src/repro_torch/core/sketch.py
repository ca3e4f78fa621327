"""Algorithm 1 of the paper: sketching matrices as accumulations of m rescaled,
randomly-signed sub-sampling matrices.

The sketch is structural: the n-by-d matrix S is never materialized.  It is
described by

  indices : (m, d) int32   — n_ij, the sampled row of the single non-zero in
                             column j of the i-th sub-sampling matrix S_(i)
  signs   : (m, d) float   — r_ij, i.i.d. Rademacher
  probs   : (n,)   float   — the sampling distribution P (p_k)

so that  S = Σ_i S_(i),  with  (S_(i))[:, j] = r_ij / sqrt(d·m·p_{n_ij}) e_{n_ij}.

Draws come from an explicit ``torch.Generator`` and do not reproduce JAX's
threefry bits; parity with the reference goes through
``repro_torch.interop.sketch_from_numpy``, which carries a JAX draw across.
The draw runs on the generator's device and the result moves to ``device``,
so one seed gives the same sketch on every device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._util import resolve_device
from repro_torch.core.schemes import validate_scheme


@dataclasses.dataclass(frozen=True)
class AccumSketch:
    """Structural representation of an accumulation-of-sub-sampling sketch.

    ``coef_`` optionally carries the precomputed (m, d) combination
    coefficients; the constructors populate it, and ``coef`` computes it for
    hand-built sketches that leave it ``None``."""

    indices: torch.Tensor               # (m, d) int32
    signs: torch.Tensor                 # (m, d) — ±1
    probs: torch.Tensor                 # (n,) sampling distribution
    n: int                              # ambient dimension (rows of S)
    coef_: torch.Tensor | None = None   # (m, d) cached r_ij / sqrt(d m p)
    scheme: str = "uniform"

    @property
    def m(self) -> int:
        """Number of accumulated sub-sampling matrices (slabs)."""
        return self.indices.shape[0]

    @property
    def d(self) -> int:
        """Sketch dimension (columns of S)."""
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        """Device the sketch's tensors live on."""
        return self.indices.device

    @property
    def coef(self) -> torch.Tensor:
        """(m, d) combination coefficients r_ij / sqrt(d m p_{n_ij})."""
        if self.coef_ is not None:
            return self.coef_
        return _compute_coef(self.indices, self.signs, self.probs)

    def truncated(self, m: int) -> "AccumSketch":
        """The sketch restricted to its first ``m`` sub-sampling matrices; the
        cached coefficients renormalize by sqrt(M/m)."""
        if not 0 < m <= self.m:
            raise ValueError(f"cannot truncate m={self.m} sketch to m={m}")
        if m == self.m:
            return self
        coef_ = None
        if self.coef_ is not None:
            coef_ = self.coef_[:m] * math.sqrt(self.m / m)
        return AccumSketch(indices=self.indices[:m], signs=self.signs[:m],
                           probs=self.probs, n=self.n, coef_=coef_,
                           scheme=self.scheme)

    def dense(self) -> torch.Tensor:
        """Materialize S (n, d) — O(n d), for tests/small problems only."""
        onehot = torch.nn.functional.one_hot(
            self.indices.long(), self.n).to(self.signs.dtype)     # (m, d, n)
        return torch.einsum("mdn,md->nd", onehot, self.coef)

    def nnz_per_column(self) -> torch.Tensor:
        """Number of distinct non-zeros per column (≤ m), computed O(m²·d)
        from ``indices``/``coef``: colliding draws whose coefficients cancel
        are zeros of S, exactly as in the dense count."""
        coef = self.coef
        eq = self.indices[:, None, :] == self.indices[None, :, :]  # (m, m, d)
        summed = torch.sum(torch.where(eq, coef[None, :, :], 0.0), dim=1)
        # entry i represents its row iff no earlier draw i' < i hit the same row
        earlier = torch.tril(torch.ones((self.m, self.m), dtype=torch.bool,
                                        device=self.device), diagonal=-1)
        seen = torch.any(eq & earlier[:, :, None], dim=1)          # (m, d)
        return torch.sum(~seen & (summed != 0), dim=0)


def _compute_coef(indices: torch.Tensor, signs: torch.Tensor,
                  probs: torch.Tensor) -> torch.Tensor:
    m, d = indices.shape
    p = probs[indices.long()]                                      # (m, d)
    return signs / torch.sqrt(d * m * p)


def _normalize_probs(probs, n: int, dtype=torch.float32,
                     device="cpu") -> torch.Tensor:
    """The one shared probs-normalization path for every sketch constructor:
    ``None`` → uniform; anything else is coerced to ``dtype`` and renormalized
    to sum 1."""
    if probs is None:
        return torch.full((n,), 1.0 / n, dtype=dtype, device=device)
    probs = torch.as_tensor(probs, dtype=dtype, device=device)
    return probs / torch.sum(probs)


def make_accum_sketch(
    generator: torch.Generator, n: int, d: int, m: int = 1, probs=None, *,
    scheme: str = "uniform", signed: bool = True, dtype=torch.float32,
    device="cuda",
) -> AccumSketch:
    """Algorithm 1: draw m·d indices from P with replacement, plus Rademacher
    signs.

    ``probs=None`` means the uniform distribution (classical Nyström when
    m=1); ``signed=False`` drops the signs.  ``scheme="leverage"`` needs an
    explicit ``probs``.  ``device`` defaults to ``"cuda"`` and raises on a
    machine without a card."""
    device = resolve_device(device)
    validate_scheme(scheme)
    if scheme == "poisson":
        raise NotImplementedError(
            "scheme='poisson' is not ported yet (ROADMAP queue 1, item 9)")
    if scheme == "leverage" and probs is None:
        raise ValueError("scheme='leverage' needs an explicit probs vector in "
                         "the one-shot constructor")
    gdev = generator.device
    if probs is None:
        indices = torch.randint(0, n, (m, d), generator=generator, device=gdev)
    else:
        p = _normalize_probs(probs, n, torch.float64, gdev)
        indices = torch.multinomial(p, m * d, replacement=True,
                                    generator=generator).reshape(m, d)
    if signed:
        bits = torch.randint(0, 2, (m, d), generator=generator, device=gdev)
        signs = (2 * bits - 1).to(dtype)
    else:
        signs = torch.ones((m, d), dtype=dtype, device=gdev)
    indices = indices.to(device=device, dtype=torch.int32)
    signs = signs.to(device)
    probs = _normalize_probs(probs, n, dtype, device)
    return AccumSketch(indices=indices, signs=signs, probs=probs, n=n,
                       coef_=_compute_coef(indices, signs, probs),
                       scheme=scheme)


def make_nystrom_sketch(generator: torch.Generator, n: int, d: int, probs=None,
                        dtype=torch.float32, *, scheme: str = "uniform",
                        device="cuda") -> AccumSketch:
    """m=1 special case — the classical (or leverage-weighted) Nyström
    sketch: ``make_accum_sketch`` with m=1, unsigned."""
    return make_accum_sketch(generator, n, d, m=1, probs=probs, scheme=scheme,
                             signed=False, dtype=dtype, device=device)


def make_gaussian_sketch(generator: torch.Generator, n: int, d: int,
                         dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    """Dense sub-Gaussian sketch (the m→∞ limit): i.i.d. N(0, 1/d)."""
    device = resolve_device(device)
    S = torch.randn((n, d), generator=generator, dtype=dtype,
                    device=generator.device)
    return (S / d**0.5).to(device)
